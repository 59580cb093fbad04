"""homerhevc_tpu_torch — the PyTorch/CUDA port of the homerhevc_tpu encoder.

The JAX package `homerhevc_tpu` is the reference: every Access Unit this
package writes must equal, byte for byte, what `homerhevc_tpu.api.
HomerEncoder(cfg, backend="jax")` writes for the same frames. This package
imports torch and never jax; it reuses the reference's jax-free host modules
(config, numpy tables, entropy coding with libhenc, AU assembly, synthetic
clips, libde265 validation) without copying them.

Supported slice: the fixed-CU P path (`performance_mode=FASTEST_COMPUTATION`,
`cu_size=32`, `me_search_range <= 24`, fixed QP, rd_mode FULL). Everything
else raises NotImplementedError naming the setting.

Layer map:
  api.py                  — HomerEncoder session (IDR + chunked P frames)
  device.py               — device checks and int32 helpers
  tables.py               — numpy spec tables + torch twins
  ops/                    — transforms, quant, intra prediction, deblock, SAO,
                            and the two kernel-backed ops (me.py, gather.py)
  pipeline/               — intra_torch (IDR wavefront), p_torch (P stage),
                            p_chunk (K-frame device loop + wire)
  kernels/                — hand-written CUDA kernels for sm_90a + build
"""

__version__ = "0.1.0"
