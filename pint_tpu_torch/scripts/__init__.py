"""Command-line entry points of the port (reference:
src/pint/scripts/; the JAX package's ``scripts/``): ``pintempo``,
``zima``, ``pintbary``, ``photonphase`` and its Fermi wrapper
``fermiphase``, and the photon MCMC tools ``event_optimize`` and
``event_optimize_multiple`` (helpers in ``_event_common``), which
evaluate a model on ``--device`` (default ``cuda``), and the host-only
par tools ``convert_parfile``,
``compare_parfiles``, ``tcb2tdb``, ``t2binary2pint`` and
``pintpublish``. Each module has ``main(argv=None) -> int`` and runs as
``python -m pint_tpu_torch.scripts.<name> ...``."""
