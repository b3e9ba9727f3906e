"""Training (port of ``busca_tpu.train``): episodes, the train step with
optax's AdamW, and the full-loop demo."""
