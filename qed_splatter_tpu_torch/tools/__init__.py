"""The port's microbenchmarks (counterparts of the JAX round's ``tools/``);
run each as ``python -m qed_splatter_tpu_torch.tools.<name>``."""
