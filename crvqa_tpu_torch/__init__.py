"""crvqa_tpu_torch — the PyTorch / CUDA (NVIDIA Hopper) port of crvqa_tpu.

The package mirrors `crvqa_tpu`'s tree (`models/`, `ops/`, `data/`,
`native/`, `masking/`, `core/`, `cli/`, `utils/`) so each module's
counterpart is found by name. It imports torch, numpy and the standard
library only — never JAX, flax, optax or anything of `crvqa_tpu`.

Every Pallas kernel of the JAX package on a ported path becomes a kernel
written by hand for Hopper under `csrc/`. A kernel's wrapper chooses by the
tensor's device: a CPU tensor takes the plain PyTorch version, a CUDA
tensor launches the kernel or raises. There is no fallback.
"""

__version__ = "0.1.0"
