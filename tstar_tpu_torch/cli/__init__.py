"""Command-line entry points (port of ``tstar_tpu/cli``): the demo."""
