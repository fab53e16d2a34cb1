"""Training of arch "de" (the JAX ``train`` package's counterpart): the loss
(``losses``), Adam with the cosine schedule (``state``) and the ``Trainer``
that trains, checkpoints and serves the generator."""
