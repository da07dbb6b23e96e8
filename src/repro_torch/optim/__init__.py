"""Optimization of the port (counterpart of `repro.optim`).

schedule  the warmup + cosine learning-rate schedule
adamw     AdamW with global-norm clipping, f32 moments
"""
