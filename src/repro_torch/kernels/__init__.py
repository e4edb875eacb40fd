"""Hand-written CUDA kernels for the SiM hot paths, with plain versions.

Every kernel directory ships two files, and its CUDA source lives in
``csrc/``:
  ops.py    — the public wrapper: checks operands, allocates outputs,
              launches the kernel on a CUDA tensor, or runs the plain
              version on a CPU tensor
  ref.py    — the plain PyTorch version the kernel is held against

``native.py`` builds ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` at first
use and counts each kernel's launches.
"""
