"""Checkpointing of the port (counterpart of `repro.checkpoint`).

ckpt  atomic `save`, `AsyncSaver`, `latest_step`, `restore` onto a device
"""
