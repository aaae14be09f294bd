"""Runnable examples of the port, ``python -m repro_torch.examples.<name>``
(counterparts of the reference's ``examples/``): ``quickstart``,
``learned_sketch``, ``butterfly_autoencoder``, ``train_lm`` and
``serve_lm``. Each runs on the card unless given ``--device cpu``."""
