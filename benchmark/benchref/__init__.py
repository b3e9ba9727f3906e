"""The benchmark's plain reference: frozen copies of the program's models
and host trackers, plain PyTorch and NumPy, importing nothing of the program
(``busca_tpu_torch``), of ``busca_tpu`` or of JAX."""
