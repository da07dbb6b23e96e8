"""The LLM serving engine of the port (counterpart of `repro.serving`).

kvcache       the paged KV cache on the §V block pool
paged_decode  one decode step through the `paged_attention` kernel
scheduler     admission: the `obs:pq` store + the §III arrival ring
prefix_cache  prefix reuse: an `obs:tiered3/lru` store of page handles
traffic       the seeded heavy-traffic trace generator and its replay
engine        `Engine`, the continuous-batching host loop
"""
