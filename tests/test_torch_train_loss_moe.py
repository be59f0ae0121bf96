"""The port's training loss against the JAX package's on the MoE, MLA and
encoder-decoder configs (reduced qwen2-moe-a2.7b, deepseek-v2-lite-16b
and seamless-m4t-medium): the loss, the MoE balance term and every
gradient leaf, through the capacity dispatch's gathers and the MLA
up-projections; remat on and off bitwise.  The tolerances and the check
are tests/test_torch_train_loss.py's."""

import pytest

from test_torch_train_loss import check_train_loss_against_jax


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b",
                                  "seamless-m4t-medium"])
def test_train_loss_and_grads_match_jax(arch):
    check_train_loss_against_jax(arch)
