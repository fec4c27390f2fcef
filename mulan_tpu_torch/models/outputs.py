"""Model output container, counterpart of `mulan_tpu/models/outputs.py`."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ELBOOutput:
  loss_recon: torch.Tensor  # (B,) nats
  loss_klz: torch.Tensor    # (B,) nats: latent KL + prior KL
  loss_diff: torch.Tensor   # (B,) nats
  var_0: torch.Tensor       # scalar, mean sigmoid(gamma_0)
  var_1: torch.Tensor       # scalar, mean sigmoid(gamma_1)
