"""Optimizers of the LM training path: AdamW, the first-order baseline that
ABO-ZO (:mod:`repro_torch.train.abo_zo`) is compared against."""
