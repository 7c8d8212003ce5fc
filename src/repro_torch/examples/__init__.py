"""The reference's five examples on the port, each a module run as
``python -m repro_torch.examples.<name>`` (on the card unless given
``--device cpu``): ``quickstart``, ``train_draft_model``,
``serve_dynamic_sl``, ``stream_serving`` and ``low_acceptance_regime``.
Each ``main(argv)`` prints the reference script's lines and returns what
it measured; importing a module runs nothing."""
