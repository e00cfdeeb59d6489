"""Synthetic, stateless-by-cursor LM data (a copy of :mod:`repro.data`)."""
