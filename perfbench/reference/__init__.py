"""Plain PyTorch references of the benchmark's configurations.

Float32 throughout (TF32 off), no kernels, no cache, no batching, from
the published description of the Mistral/Mixtral block. They import
neither JAX nor the package under test: only torch and the benchmark's
own weight draws (``perfbench.weights``), so they take nothing the
program made.
"""
