"""The FLOP counter against hand counts."""

from benchmark.harness import flops
from benchmark.reference.mulan import Model


def test_resnet_block_by_hand():
  # 128 -> 128 at 32x32: two 3x3 convolutions, the conditioning's
  # projection 512 -> 128; a multiply-add is two operations.
  conv = 2 * 128 * 128 * 9 * 1024
  assert flops.resnet_block(128, 128, 512, 1024) == 2 * conv + 2 * 512 * 128
  # 256 -> 128 (an up block): a 3x3 convolution from 256 channels, one from
  # 128, and the 1x1 shortcut from 256.
  assert flops.resnet_block(256, 128, 512, 1024) == (
      2 * 256 * 128 * 9 * 1024 + conv + 2 * 512 * 128
      + 2 * 256 * 128 * 1024)


def test_attention_block_by_hand():
  # q, k, v and the output projection: 4 x (1024 x 128 x 128) multiply-adds;
  # Q K^T and P V: 2 x (1024 x 1024 x 128).
  assert flops.attention_block(128, 1024) == (
      4 * 2 * 1024 * 128 * 128 + 2 * 2 * 1024 * 1024 * 128)


def test_totals_compose_the_blocks():
  m = Model('velocity')
  c, cond, px = 128, 512, 1024
  unet = (2 * (c + 50) * cond + 2 * cond * cond
          + 2 * 15 * c * 9 * px
          + 34 * flops.resnet_block(c, c, cond, px)
          + flops.attention_block(c, px)
          + 33 * flops.resnet_block(2 * c, c, cond, px)
          + 2 * c * 3 * 9 * px)
  assert flops.score_unet(m) == unet
  per_image = unet + flops.encoder(m) + flops.gamma_network(m)
  assert flops.train_step(m, 128) == 3 * 128 * per_image
  assert flops.dense_chunk(m, 4, 128) == (
      4 * flops.encoder(m) + 512 * (unet + flops.gamma_network(m)))
  # The flagship's forward is about 57.8 GFLOP an image.
  assert 57e9 < per_image < 58.5e9


def test_kernel_bounds_match_the_ports_table():
  """The bounds PERF.md's kernel table gives at the flagship's shapes."""
  from benchmark.harness import roofline as r
  att = (128, 1, 1024, 128)
  assert abs(r.attention_fwd_flops(*att) - 68.7e9) < 0.1e9
  assert abs(r.bound_s(r.attention_fwd_flops(*att), 0, 'bfloat16')
             - 0.0695e-3) < 0.0001e-3
  assert abs(r.attention_bwd_dkv_flops(*att) - 137e9) < 1e9
  assert abs(r.attention_bwd_dq_flops(*att) - 103e9) < 1e9
  pixels = 128 * 32 * 32 * 3
  assert abs(r.decoder_bytes(pixels) - 3 * 1.57e6) < 0.02e6
  site = 128 * 128 * 32 * 32
  assert abs(r.mask_bytes(site) - 33.5e6) < 0.1e6
  assert abs(r.bound_s(0, r.mask_bytes(site), 'bfloat16') - 0.0100e-3) < (
      0.0001e-3)
  assert abs(r.mask_bytes(site, masks=67) - 2.25e9) < 0.01e9
  assert abs(r.bound_s(0, r.gn_swish_bytes(site), 'bfloat16')
             - 0.0200e-3) < 0.0001e-3
  assert abs(r.bound_s(0, r.gn_swish_bwd_bytes(site), 'bfloat16')
             - 0.0300e-3) < 0.0001e-3
