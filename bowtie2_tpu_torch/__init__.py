"""bowtie2_tpu_torch — the PyTorch/CUDA port of bt2x for NVIDIA Hopper.

Same algorithmic contract and SAM output as the JAX package, with the
device loops (FM search, SA resolve, rectangle DP, backtrace) written by
hand in CUDA C++ (`csrc/`). Importing the package has no side effects:
no device is touched and nothing is built until a kernel is first launched.
"""

__version__ = "0.1.0"
