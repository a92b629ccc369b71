"""PyTorch/CUDA port of the Q-GenX system (the JAX package ``repro`` is the
reference).

Layout mirrors ``src/repro/`` so each module's counterpart is easy to
find: ``configs/``, ``core/`` (quantization, exchange plan, exchange,
method algebra), ``kernels/`` (hand-written CUDA kernels for the exchange,
each beside its plain PyTorch version), ``optim/`` (the adam family and
qgenx), ``models/``, ``gan/`` (the paper's WGAN-GP testbed), ``data/`` and
``launch/`` (the LM trainer ``train`` and the GAN experiment
``train_gan``).  The package imports torch and numpy only.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for ``cuda`` without a GPU raises (:func:`repro_torch.device.resolve_device`).
"""
