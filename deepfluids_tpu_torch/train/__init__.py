"""Training of archs "de", "ae" and "nn" (the JAX ``train`` package's
counterpart): the losses (``losses``), Adam with the cosine schedule
(``state``), the x-mirror augmentation (``augment``) and the ``Trainer``
that trains, checkpoints and serves a run."""
