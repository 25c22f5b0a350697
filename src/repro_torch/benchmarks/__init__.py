"""The paper-figure benchmarks on the port's simulator (counterparts of the
top-level ``benchmarks/`` modules, which import the reference).

    PYTHONPATH=src python -m repro_torch.benchmarks.fig8_microbench --full
    PYTHONPATH=src python -m repro_torch.benchmarks.fig7_routing_pingpong \
        --device cpu --topology aries:n_groups=4,chassis_per_group=2,blades_per_chassis=4

Each prints ``name,us_per_call,derived`` rows.  The simulator runs on
the CUDA card unless ``--device cpu`` (or ``device="cpu"``) is given.
"""
