"""The benchmark's hooks on the trainer: a method it hooks that the
trainer's class no longer has stops the run with its name, and the set-up
panel check refuses a graph that lost genes of the configuration."""
from types import SimpleNamespace as NS

import pandas as pd
import pytest

import harness
import hooks
from generator import CYTOPLASMIC, NUCLEUS


class Trainer:
    def _build_batch(self, plan, cache=True):
        return plan

    def _batch_plans(self, specs):
        return specs

    def _stage(self, steps, batch, gen=None, weights=None):
        return None

    def _run(self, kind, step):
        return kind


def test_the_hooks_come_off_again():
    tr = Trainer()
    seen = []
    with hooks.labelled(tr, lambda plan, batch: seen.append(plan)):
        assert set(vars(tr)) == set(hooks.METHODS)
        assert tr._build_batch("p") == "p" and tr._run("train", 0) == "train"
    assert not vars(tr) and seen == ["p"]


@pytest.mark.parametrize("method", hooks.METHODS)
def test_a_renamed_method_stops_the_run(method):
    cls = type("Renamed", (Trainer,), {method: None})
    with pytest.raises(hooks.HookError, match=method):
        with hooks.labelled(cls(), lambda plan, batch: None):
            pass


def test_a_recorder_that_saw_too_few_steps_stops_the_run():
    tr = Trainer()
    tr.device = NS(type="cpu")
    tr.model = NS(named_parameters=lambda: [])
    rec = hooks.StepRecorder(tr, 3)
    with pytest.raises(hooks.HookError, match="fewer than the 3"):
        rec.close()
    assert not vars(tr).get("_stage")


def slide(genes, compartments, cells):
    return pd.DataFrame({"feature_name": genes,
                         "cell_compartment": compartments,
                         "cell_id": cells})


CONFIG = {"slide": {"n_genes": 3},
          "pipeline": {"segmentation_graph_mode": "nucleus"}}


def test_the_panel_check():
    tx = slide(["a", "b", "c", "c", "b"],
               [NUCLEUS, NUCLEUS, NUCLEUS, CYTOPLASMIC, CYTOPLASMIC],
               ["x", "x", "y", "y", None])
    harness.check_panel(tx, NS(n_genes=3, n_tx=5), CONFIG)
    # a gene the count matrix holds, filtered out with its transcripts
    with pytest.raises(harness.SpecError, match="panel is cut"):
        harness.check_panel(tx, NS(n_genes=2, n_tx=3), CONFIG)
    # a gene with no nucleus transcript cannot enter; under 99 % of the
    # configuration's genes is too few all the same
    tx.loc[2, "cell_compartment"] = CYTOPLASMIC
    harness.check_panel(tx, NS(n_genes=2, n_tx=3),
                        dict(CONFIG, slide={"n_genes": 2}))
    with pytest.raises(harness.SpecError, match="panel is cut"):
        harness.check_panel(tx, NS(n_genes=2, n_tx=3), CONFIG)
