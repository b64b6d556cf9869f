"""The port's whole-slide training over several processes on the CPU:
``fit_whole_slide`` for two epochs on two gloo ranks of two CPU shards
each (``tests/_torch_multiprocess_worker.py``), at 4 strips and on the
2x2 grid, against the port's one-process fit over 4 CPU shards from the
same seeded init, on ``tests/_multihost_worker.py``'s slide.

Each shard draws from ``shard_generator(epoch, d)`` with its global shard
id, so both runs use the same random numbers; the loss statistics and the
gradient are summed over the ranks by all-reduces, in another order than
autograd sums the shards' in one process, which moves their last bits.
Where a parameter's gradient is far below Adam's ``eps`` of 1e-8 (the
loss barely reaches it), those bits can be a large share of it, and
Adam's ``g / (|g| + eps)`` turns them into a step of up to
``lr * |g| / eps``.  So the
parameters are held as ``tests/test_torch_port_tile_dp.py`` holds the
tile-data-parallel fit: within 1e-6 where the root mean square of the
gradient exceeds ``HELD_RMS``, Adam's ``eps`` (this small encoder's
gradients are smaller than the tile-DP test's, whose threshold is 1e-4),
and within a tenth of the learning rate everywhere.  On this slide the
strips' largest gap is 5.8e-7 (gradient RMS 2.6e-10) and the grid's
4.5e-6 (one parameter of 4,992, gradient RMS 6.3e-12, 13% apart between
the two runs); where the RMS exceeds ``HELD_RMS`` the largest is 8e-8.
"""
import numpy as np
import pytest

from segger_tpu_torch.train.trainer import TrainConfig

from tests import _torch_multiprocess_worker as worker
from tests.test_torch_port_multiprocess import (
    LAYOUTS, assert_ranks_ok, multihost_graph, write_slide,
)

HELD_RMS = 1e-8                   # Adam's eps


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    work = tmp_path_factory.mktemp("multiprocess_train")
    write_slide(work, multihost_graph())
    assert_ranks_ok(worker.run_ranks("train", work))
    return worker.results(work)


def _losses(fit):
    return {k: [h[k] for h in fit["history"]] for k in fit["history"][0]}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fit_losses_match_one_process(fits, layout):
    """Every epoch's loss and its three parts within 1e-6 relative of the
    one-process fit's."""
    got, want = fits[0][layout], fits[0][f"{layout} one process"]
    assert len(got["history"]) == worker.EPOCHS
    assert [h["epoch"] for h in got["history"]] == list(range(worker.EPOCHS))
    for k, v in _losses(want).items():
        np.testing.assert_allclose(_losses(got)[k], v, rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fit_parameters_match_one_process(fits, layout):
    """The parameters after the fit against the one-process fit's: within
    1e-6 where the gradient's root mean square exceeds ``HELD_RMS`` (more
    than seven tenths of them), within a tenth of the learning rate
    everywhere."""
    got, want = fits[0][layout], fits[0][f"{layout} one process"]
    lr = TrainConfig().learning_rate
    np.testing.assert_allclose(got["params"], want["params"], rtol=0,
                               atol=lr / 10)
    held = want["grad_rms"] > HELD_RMS
    assert held.mean() > 0.7, held.mean()
    np.testing.assert_allclose(got["params"][held], want["params"][held],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_end_equal(fits, layout):
    """Every rank applies the same Adam step from the same all-reduced
    gradient: the histories and the parameters are equal across ranks."""
    r0, r1 = fits[0][layout], fits[1][layout]
    assert r0["history"] == r1["history"]
    np.testing.assert_array_equal(r0["params"], r1["params"])
    np.testing.assert_array_equal(r0["grad_rms"], r1["grad_rms"])
