"""CLI entry for the ode_encode variant (ref neural_00_ODE_02_direct_encode.py)."""

from py_psnode_tpu_torch.cli.common import main

if __name__ == "__main__":
    main("ode_encode")
