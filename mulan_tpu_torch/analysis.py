"""Analysis helpers: model probes, schedule figures and clustering,
counterpart of `mulan_tpu/analysis.py`.

  * `get_logits` and `noise_schedule_per_embedding` probe a checkpoint's
    EMA model (the encoder's logits of eval batches, and the per-pixel
    schedule gamma(z, t) on a grid of t), on the experiment's device and
    without gradients; `get_embedding` is the shifted canonical top-k
    pattern.
  * `cluster_embeddings` groups examples whose hard latents share their
    support: greedy leader clustering on cosine similarity, in numpy.
  * The figures (`cluster_gallery`, `schedule_curves`, `schedule_heatmap`,
    `schedule_histograms`, `embedding_scatter`) each return a matplotlib
    Figure; `animate` returns a FuncAnimation; `pca_transformation`,
    `tsne_transformation` and `dct2` project or transform numpy data.

matplotlib, sklearn and scipy are imported inside the functions that use
them, so the module imports with torch and numpy alone.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

_LUMA = np.array([0.2126, 0.7152, 0.0722])  # Rec. 709 luma weights


# -- model probes ---------------------------------------------------------------


@torch.no_grad()
def get_logits(experiment, num_batches: int = 30):
  """(logits (N, latent_size) on the experiment's device, images (N, H, W,
  C) uint8 numpy) of `num_batches` batches of the experiment's eval
  iterator, through the EMA model's encoder (`analysis.py:get_logits`)."""
  logits, images = [], []
  model = experiment.state.ema_model
  for _ in range(num_batches):
    batch = np.asarray(next(experiment.eval_iter)['images'])
    logits.append(model.apply_encoder(batch))
    images.append(batch)
  return torch.cat(logits), np.concatenate(images)


@torch.no_grad()
def noise_schedule_per_embedding(experiment, embeddings, time_steps=None,
                                 n_grid: int = 128) -> List[torch.Tensor]:
  """gamma(z, t) over a grid of t (default `n_grid` points in [0, 1]) for
  each embedding z of `embeddings` (B, width): a list of B (T, n_pixels)
  tensors, from the EMA model's `gamma_of`."""
  model = experiment.state.ema_model
  device = model.device
  if time_steps is None:
    time_steps = torch.linspace(0, 1, n_grid, device=device)
  time_steps = torch.as_tensor(time_steps, dtype=torch.float32,
                               device=device)
  embeddings = torch.as_tensor(embeddings, device=device)
  return [model.gamma_of(embeddings[i:i + 1].repeat(len(time_steps), 1),
                         time_steps) for i in range(embeddings.shape[0])]


def get_embedding(batch_size: int = 2, latent_size: int = 50, k: int = 15,
                  shift: int = 0) -> torch.Tensor:
  """(batch_size, latent_size) rows of k ones then zeros, rolled right by
  `shift` (`analysis.py:get_embedding`)."""
  ones = torch.ones((batch_size, k))
  zeros = torch.zeros((batch_size, latent_size - k))
  return torch.roll(torch.cat([ones, zeros], dim=1), shifts=shift, dims=1)


# -- clustering by latent similarity --------------------------------------------


@dataclasses.dataclass
class EmbeddingClusters:
  """Disjoint clusters of examples with similar hard latents.

  `assignment[i]` is the cluster id of example i (or -1 for unclustered
  singletons); `members(c)` lists a cluster's examples, leader first.
  """

  assignment: np.ndarray       # (N,) int
  leaders: np.ndarray          # (n_clusters,) leader example index
  similarity: np.ndarray       # (N, N) cosine similarity

  @property
  def n_clusters(self) -> int:
    return len(self.leaders)

  def members(self, cluster_id: int) -> List[int]:
    idx = np.where(self.assignment == cluster_id)[0].tolist()
    leader = int(self.leaders[cluster_id])
    return [leader] + [i for i in idx if i != leader]


def cluster_embeddings(embeddings, *, min_cosine: float = 0.9,
                       min_size: int = 2,
                       max_size: Optional[int] = None) -> EmbeddingClusters:
  """Greedy leader clustering on cosine similarity
  (`analysis.py:cluster_embeddings`): examples are visited in order; each
  unassigned one leads a new cluster of every other unassigned example at
  cosine >= `min_cosine` to it (leader first, cut to `max_size`); clusters
  smaller than `min_size` are dissolved (assignment -1). For hard top-k
  latents the cosine m/k counts the m shared entries."""
  emb = np.asarray(embeddings, np.float64)
  norms = np.linalg.norm(emb, axis=1, keepdims=True)
  unit = emb / np.maximum(norms, 1e-12)
  sim = unit @ unit.T

  n = len(emb)
  assignment = np.full(n, -1, np.int64)
  leaders: List[int] = []
  for i in range(n):
    if assignment[i] != -1:
      continue
    cand = np.where((sim[i] >= min_cosine) & (assignment == -1))[0]
    mates = [i] + [int(j) for j in cand if j != i]
    if max_size is not None:
      mates = mates[:max_size]
    if len(mates) < min_size:
      continue
    assignment[np.asarray(mates)] = len(leaders)
    leaders.append(i)
  return EmbeddingClusters(assignment=assignment,
                           leaders=np.asarray(leaders, np.int64),
                           similarity=sim)


def cluster_gallery(images, clusters: EmbeddingClusters, *,
                    max_clusters: int = 16, row_height: float = 1.2):
  """One row of images per cluster, leader first. Returns a Figure."""
  import matplotlib.pyplot as plt
  images = np.asarray(images)
  rows = [clusters.members(c)
          for c in range(min(clusters.n_clusters, max_clusters))]
  if not rows:
    return plt.figure()
  width = max(len(r) for r in rows)
  fig, axes = plt.subplots(len(rows), width,
                           figsize=(width * row_height,
                                    len(rows) * row_height),
                           squeeze=False)
  for r, members in enumerate(rows):
    for c in range(width):
      ax = axes[r][c]
      ax.set_axis_off()
      if c < len(members):
        ax.imshow(images[members[c]])
        if c == 0:
          ax.set_title(f'#{r}', fontsize=8)
  fig.tight_layout(pad=0.1)
  return fig


# -- projections ----------------------------------------------------------------


def pca_transformation(data, n_components: int = 4):
  from sklearn.decomposition import PCA
  return PCA(n_components=n_components,
             svd_solver='full').fit_transform(np.asarray(data))


def tsne_transformation(data, perplexity: int = 25):
  from sklearn.manifold import TSNE
  return TSNE(2, perplexity=perplexity).fit_transform(np.asarray(data))


def dct2(image):
  """Type-II orthonormal 2-D DCT of an image (its luma if RGB)."""
  import scipy.fftpack
  image = np.asarray(image, np.float64)
  if image.ndim == 3:
    image = image @ _LUMA
  return scipy.fftpack.dct(
      scipy.fftpack.dct(image, axis=0, norm='ortho'), axis=1, norm='ortho')


# -- schedule figures -----------------------------------------------------------


def _row_at(grid: np.ndarray, t: float) -> np.ndarray:
  """The grid's row nearest to time t in [0, 1]."""
  return grid[min(int(round(t * (grid.shape[0] - 1))), grid.shape[0] - 1)]


def schedule_curves(gamma_grids: Sequence[np.ndarray],
                    labels: Optional[Sequence[str]] = None,
                    reduce: Callable = np.mean):
  """gamma(t) reduced over the pixels, one curve per (T, n_pixels) grid, on
  one axes. Returns a Figure."""
  import matplotlib.pyplot as plt
  fig, ax = plt.subplots()
  for i, grid in enumerate(gamma_grids):
    grid = np.asarray(grid)
    t = np.linspace(0, 1, grid.shape[0])
    label = labels[i] if labels is not None else None
    ax.plot(t, reduce(grid, axis=1), label=label)
  ax.set_xlabel('t')
  ax.set_ylabel(r'$\gamma(t)$')
  if labels is not None:
    ax.legend(fontsize=8)
  return fig


def schedule_heatmap(gamma_grid: np.ndarray, image_shape, *,
                     times: Sequence[float] = (0, .25, .5, .75, 1.0),
                     cmap: str = 'magma', panel_inches: float = 1.6):
  """Per-pixel gamma maps at `times`, one panel each (RGB as its luma), on
  one color scale: the whole grid's [min, max]. Returns a Figure."""
  import matplotlib.pyplot as plt
  grid = np.asarray(gamma_grid)
  lo, hi = grid.min(), grid.max()
  fig, axes = plt.subplots(1, len(times),
                           figsize=(panel_inches * len(times),
                                    panel_inches), squeeze=False)
  for ax, t in zip(axes[0], times):
    img = _row_at(grid, t).reshape(image_shape)
    if img.ndim == 3:
      # _LUMA sums to 1, so [lo, hi] still bounds the luma.
      img = img @ _LUMA if img.shape[-1] == 3 else img.mean(axis=-1)
    ax.imshow(img, cmap=cmap, vmin=lo, vmax=hi, interpolation='nearest')
    ax.set_title(f't={t:.2f}', fontsize=8)
    ax.set_axis_off()
  fig.tight_layout(pad=0.1)
  return fig


def schedule_histograms(gamma_grid: np.ndarray, *,
                        times: Sequence[float] = (0, .5, 1.0),
                        bins: int = 64, panel_inches: float = 1.6):
  """Histograms of the per-pixel gamma at `times`, over the grid's
  [min, max]. Returns a Figure."""
  import matplotlib.pyplot as plt
  grid = np.asarray(gamma_grid)
  lo, hi = float(grid.min()), float(grid.max())
  fig, axes = plt.subplots(1, len(times),
                           figsize=(panel_inches * len(times),
                                    panel_inches), squeeze=False)
  for ax, t in zip(axes[0], times):
    ax.hist(_row_at(grid, t), bins=bins, range=(lo, hi + 1e-9))
    ax.set_title(f't={t:.2f}', fontsize=8)
    ax.set_yticks([])
  fig.tight_layout(pad=0.1)
  return fig


def embedding_scatter(points: np.ndarray, colors=None):
  """2-D scatter of projected embeddings, colored by `colors` (cluster
  ids; those < 0, the unclustered, in grey). Returns a Figure."""
  import matplotlib.pyplot as plt
  points = np.asarray(points)
  fig, ax = plt.subplots()
  if colors is None:
    ax.scatter(points[:, 0], points[:, 1], s=12)
    return fig
  colors = np.asarray(colors)
  unclustered = colors < 0
  if unclustered.any():
    ax.scatter(points[unclustered, 0], points[unclustered, 1], c='0.75',
               s=12, label='unclustered')
    ax.legend(loc='best', fontsize=8)
  ax.scatter(points[~unclustered, 0], points[~unclustered, 1],
             c=colors[~unclustered], s=12)
  return fig


def animate(draw_fn: Callable[[object, int], None], n_frames: int, *,
            interval_ms: int = 200, figsize=None):
  """A FuncAnimation whose frame i clears the axes and calls
  `draw_fn(ax, i)`, e.g. `animate(lambda ax, i: ax.imshow(frames[i]),
  len(frames))`."""
  import matplotlib.pyplot as plt
  from matplotlib import animation as mpl_animation
  fig, ax = plt.subplots(figsize=figsize)

  def frame(i):
    ax.clear()
    draw_fn(ax, i)
    return ()

  return mpl_animation.FuncAnimation(fig, frame, frames=n_frames,
                                     interval=interval_ms, repeat=True)
