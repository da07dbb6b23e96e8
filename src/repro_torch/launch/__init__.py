"""Launchers of the port (counterpart of `repro.launch`).

train  `python -m repro_torch.launch.train`: the training loop
serve  `python -m repro_torch.launch.serve`: the continuous-batching engine
"""
