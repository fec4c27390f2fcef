"""Networks, schedule, latents and the MuLAN model (PyTorch)."""
