"""Hand-written Hopper kernels of the port and their plain versions."""

# The devices whose tensors take the plain versions: the CPU (the tests'
# path) and `meta` (`utils/mfu.count_flops`, which counts the model's work
# through them). CUDA tensors launch the kernels or raise.
PLAIN_DEVICES = ("cpu", "meta")
