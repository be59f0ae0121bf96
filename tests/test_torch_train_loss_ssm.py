"""The port's training loss against the JAX package's on the SSM and hybrid
configs (reduced mamba2-370m and zamba2-7b, on their ``ssd: chunked``
backend, which is plain PyTorch in the port as it is plain jnp in JAX):
the loss and every gradient leaf, the zamba2 stack's ``shared`` slot and
``emb0`` included; remat on and off bitwise.  The tolerances and the
check are tests/test_torch_train_loss.py's."""

import pytest

from test_torch_train_loss import check_train_loss_against_jax


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_train_loss_and_grads_match_jax(arch):
    check_train_loss_against_jax(arch)
