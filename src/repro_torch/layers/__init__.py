"""Composable NN layers of the port (functional: init/apply pairs over
dicts of tensors), all dispatching matmuls and mixers through the port's
backend registry — counterpart of :mod:`repro.layers`."""

from repro_torch.layers import attention, common, mlp  # noqa: F401
