"""Hand-written CUDA kernels for Hopper (sm_90a) and their build code.

  me_sad.cu      — SAD sweep + first-minimum argmin (replaces
                   homerhevc_tpu/ops/me_pallas.py); wrapper ops/me.py
  gather_win.cu  — per-block window gather (replaces
                   homerhevc_tpu/ops/gather_pallas.py); wrapper ops/gather.py
"""
