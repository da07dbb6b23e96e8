"""Hand-written CUDA kernels of the port (sm_90a) and their plain versions.

Each kernel is a package of three files, as in `repro.kernels`:
`kernel.py` (the wrapper: launches the CUDA kernel on CUDA tensors, runs
the plain version on CPU tensors), `ref.py` (the plain PyTorch version of
the same function, plus the state-level references the `torch` exec mode
runs) and `ops.py` (state -> layout -> kernel glue). The CUDA sources live
in `csrc/`; `cuda.py` builds, loads and counts them.

skiplist_search   det-skiplist FIND (level walk)
hash_probe        fixed-hash bucket probe
tier_find         fused hot -> warm -> spill FIND
tier_apply        fused tier-apply prologue (membership + hot insert plan)
bskiplist_walk    det-skiplist FIND through the block-major B-skiplist view
pq_pop            priority-queue rank-select over the live prefix + walk
splitorder_probe  two-level split-order FIND (per-table binary search)
paged_attention   GQA decode attention over the block pool's KV pages
flash_attention   causal GQA prefill attention (online softmax, windows)
selective_scan    the mamba-1 recurrence with its state in registers
"""
