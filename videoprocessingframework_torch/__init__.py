"""PyTorch/CUDA port of videoprocessingframework_tpu for NVIDIA Hopper.

The main path: host libav decode (io/pool.py) → one hand-written CUDA
kernel for resize + colour conversion (ops/fused_cuda.py,
csrc/fused_resize_csc.cu) → ResNet (models/resnet.py).
"""

__version__ = "0.1.0"
