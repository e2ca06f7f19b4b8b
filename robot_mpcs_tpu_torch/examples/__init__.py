"""The port's example scenarios and ``make_solver`` (port of ``examples/``),
each runnable as ``python -m robot_mpcs_tpu_torch.examples.<name>``."""
