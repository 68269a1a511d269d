"""``tests/test_torch_seq_parallel.py``'s training checks on 2x2 gloo
ranks, in their own file (one spawn, run beside that file's): the "hidden"
and "replicated" residuals with the xla dots tensor-parallel against the
reference's unsharded train step, on the granite-moe-1b-a400m smoke R&B
and the mistral-large-123b smoke, with ``cfg.fsdp`` off and on, without
microbatches and with 2 ("seq" on 2x2 is ``tests/test_torch_train_mesh
.py``'s)."""
import pytest

import test_torch_seq_parallel as sp
import test_torch_train_mesh as tm


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", tm.NAMES)
@pytest.mark.parametrize("mode", sp.MODES["2x2"])
def test_loss_and_grads_match_unsharded_reference(mode, name, fsdp):
    sp.check_loss_and_grads("2x2", mode, name, fsdp)


@pytest.mark.parametrize("mb", tm.MB)
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name", tm.NAMES)
@pytest.mark.parametrize("mode", sp.MODES["2x2"])
def test_train_steps_match_unsharded_reference(mode, name, fsdp, mb):
    sp.check_train_steps("2x2", mode, name, fsdp, mb)
