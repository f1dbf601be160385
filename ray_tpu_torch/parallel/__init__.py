"""Training on one device or over a mesh of ranks: the optax subset the
reference calls (``transforms``), compact AdamW (``optim``), the
train-program assembly (``spmd``), meshes and their collectives
(``mesh``, ``collectives``, ``pipeline``, ``multihost``) and slice
topologies (``topology``)."""
