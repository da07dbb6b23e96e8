"""Input data of the port (counterpart of `repro.data`).

pipeline  `synth_batch` and `PrefetchPipeline`, on the §V block pool and
          the §III ring queue
"""
