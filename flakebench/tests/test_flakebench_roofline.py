"""The roofline work counts, from shapes and the configuration alone."""

import json

import pytest

from conftest import REPO
from flakebench import roofline
from flakebench.reference.flac_plain import Config


def _cfg(name):
    return Config.from_file(json.loads(
        (REPO / "flakebench" / "configs" / f"{name}.json").read_text()))


def test_level8_512_frames_matches_the_kernel_table():
    """PERF.md's kernel table at the level-8 batch of 512 frames (1,024
    streams of 4,096): K4's sweep 2 x 1024 x 4096 x 78 = 0.654 G
    operations; K1's 16.9 MB."""
    work = roofline.stage_work(512, _cfg("level8_cd"))
    assert work["sweep"][1] == 2 * 1024 * 4096 * 78 == 654_311_424
    assert round(work["lags"][0] / 1e6, 1) == 16.9
    assert round(work["lags"][1] / 1e9, 3) == 0.113


def test_layers_sum_their_stages():
    cfg = _cfg("level8_cd")
    work = roofline.stage_work(8192, cfg)
    nbytes, ops = roofline.layer_work("analysis", 8192, cfg)
    assert ops == sum(o for k, (_, o) in work.items() if k != "slots")
    assert nbytes == 8192 * 4096 * 2 * 4 * 2 + 8192 * 2 * (32 + 64 + 8) * 4 \
        + 8192 * 16
    e_bytes, e_ops = roofline.layer_work("emission", 8192, cfg)
    assert e_ops == work["slots"][1] and e_bytes > 8192 * 4096 * 2 * 4
    # EST runs no sweep: no sweep, partition sums or scan
    assert not {"sweep", "partition_sums", "rice_scan"} & set(
        roofline.stage_work(8192, _cfg("level5_cd")))
    with pytest.raises(ValueError):
        roofline.layer_work("crc", 1, cfg)


def test_least_time_is_the_larger_bound():
    assert roofline.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.least_ms(0, 33.5e9) == pytest.approx(1.0)
    assert roofline.least_ms(3.35e9, 67e9) == pytest.approx(2.0)


def test_share_over_100_raises_and_is_not_printed():
    assert roofline.share(1.0, 4.0) == 25.0
    with pytest.raises(ValueError):
        roofline.share(1.0, 0.9)
    from flakebench import run

    reader = run.readers()["roofline.analysis"]
    cfg = json.loads((REPO / "flakebench/configs/level8_cd.json").read_text())
    rec = {"frames": 8192, "config": cfg, "analysis_ms": [1e-3] * 3}
    with pytest.raises(ValueError):
        reader.read(rec)
    assert reader.read({"frames": 8192, "config": cfg}) is None
