#!/usr/bin/env python3
"""Console app of the PyTorch/CUDA port (homerhevc_tpu_torch/app.py):
encodes a planar YUV420 file into an Annex-B .265 file on the GPU, with
the flags of homer_app.py.

    python3 homer_app_torch.py -i in.yuv -o out.265 -widthxheight 1920x1080 \\
        -performance_mode 3 -bitrate_mode 1 -bitrate 1250 -metrics
    python3 homer_app_torch.py -i in.yuv -o out.265 -device cpu ...  # no GPU
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from homerhevc_tpu_torch.app import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
