"""The port's runnable examples: counterparts of the top-level
``examples/`` scripts (which import the reference), with the same steps
and sizes, on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.examples.train_lm [--arch A --full]
    PYTHONPATH=src python -m repro_torch.examples.noise_aware_collectives

Each module's ``main(argv)`` does the work and returns what it printed
as numbers; importing one runs nothing.
"""
