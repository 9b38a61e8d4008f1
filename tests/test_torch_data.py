"""``repro_torch.data.pipeline`` on the CPU: the same batches as
``repro.data.pipeline``, bit for bit, for the same (seed, step), embeds
included; and the reference's three ``test_pipeline_*`` cases ported."""
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as jpipeline
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline, batch_for_step

SHAPE = ShapeConfig("t", 64, 4, "train")


@pytest.mark.parametrize("arch,embeds", [("repro-100m", False), ("zamba2-2.7b", False),
                                         ("musicgen-large", True), ("internvl2-76b", True)])
@pytest.mark.parametrize("seed,step", [(1234, 0), (7, 13), (3, 150)])
def test_batches_are_the_references_bit_for_bit(arch, embeds, seed, step):
    got = batch_for_step(get_config(arch, smoke=True), SHAPE, DataConfig(seed=seed), step,
                         embeds=embeds)
    want = jpipeline.batch_for_step(jget_config(arch, smoke=True), JShapeConfig("t", 64, 4,
                                                                                "train"),
                                    jpipeline.DataConfig(seed=seed), step, embeds=embeds)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_iterates_the_references_batches():
    cfg = get_config("musicgen-large", smoke=True)
    jcfg = jget_config("musicgen-large", smoke=True)
    pipe = TokenPipeline(cfg, SHAPE, DataConfig(seed=11), start_step=2, embeds=True)
    jpipe = jpipeline.TokenPipeline(jcfg, JShapeConfig("t", 64, 4, "train"),
                                    jpipeline.DataConfig(seed=11), start_step=2, embeds=True)
    try:
        for _ in range(3):
            got, want = next(pipe), next(jpipe)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        assert pipe.peek_step() == jpipe.peek_step() == 5
    finally:
        pipe.close()
        jpipe.close()


def test_pipeline_deterministic_per_step():
    cfg = get_config("repro-100m", smoke=True)
    a = batch_for_step(cfg, SHAPE, DataConfig(seed=7), step=13)
    b = batch_for_step(cfg, SHAPE, DataConfig(seed=7), step=13)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = batch_for_step(cfg, SHAPE, DataConfig(seed=7), step=14)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_pipeline_resume_matches_stateless():
    cfg = get_config("repro-100m", smoke=True)
    pipe = TokenPipeline(cfg, SHAPE, DataConfig(seed=3), start_step=5)
    got = next(pipe)
    pipe.close()
    want = batch_for_step(cfg, SHAPE, DataConfig(seed=3), step=5)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_pipeline_labels_shifted():
    cfg = get_config("repro-100m", smoke=True)
    b = batch_for_step(cfg, SHAPE, DataConfig(seed=1), step=0)
    assert b["tokens"].shape == b["labels"].shape == (4, 64)
    assert (b["labels"] < cfg.vocab_size).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
