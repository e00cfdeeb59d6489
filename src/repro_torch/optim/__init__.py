"""Optimizers: AdamW, the first-order baseline that ABO-ZO
(:mod:`repro_torch.train.abo_zo`) is compared against on the LM training
path, and Nelder-Mead, the paper's baseline that ABO is compared against
(:mod:`repro_torch.optim.nelder_mead`)."""
from repro_torch.optim.nelder_mead import NMResult, nelder_mead, simplex_bytes

__all__ = ["NMResult", "nelder_mead", "simplex_bytes"]
