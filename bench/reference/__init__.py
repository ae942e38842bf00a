"""The plain references the benchmark holds the program to. They import
nothing of the program (`repro_torch`), nor `jax` or the JAX package,
and take nothing the program made: they work every derived table out
again from the inputs the benchmark made."""
