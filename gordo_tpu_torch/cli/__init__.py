"""The port's command line: ``python -m gordo_tpu_torch.cli build|run-server``."""
