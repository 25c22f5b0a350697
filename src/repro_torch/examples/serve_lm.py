"""Batched serving example: prefill and decode with the family-uniform
engine, for every ``--arch`` (the enc-dec and VLM families with their
stub frontends), at the arch's reduced size.

Counterpart of ``examples/serve_lm.py``, through
:func:`repro_torch.launch.serve.main`:

    PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    """Serves 4 requests of 12 prompt tokens, 12 new tokens each;
    returns the launcher's requests."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a, _ = ap.parse_known_args(argv)
    return serve_main(["--arch", a.arch, "--smoke", "--requests", "4",
                       "--prompt-len", "12", "--new-tokens", "12"]
                      + (["--device", a.device] if a.device else []))


if __name__ == "__main__":
    main()
