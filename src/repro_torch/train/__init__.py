"""Training of the port (counterpart of `repro.train`).

step  loss_fn, grads_of (microbatch accumulation), make_train_step, and
      the serve prefill / decode steps
loop  `train`: the fault-tolerant loop (checkpoint/restart, prefetch)
"""
