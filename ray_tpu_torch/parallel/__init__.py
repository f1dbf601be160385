"""Training on one device: the optax subset the reference calls
(``transforms``), compact AdamW (``optim``) and the train-program
assembly (``spmd``).  Meshes and multi-GPU layouts are a later slice."""
