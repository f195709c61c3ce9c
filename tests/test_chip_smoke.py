"""chip_smoke.py away from the card: it refuses to run without a GPU, and
its comparison helpers accept what agrees and reject what does not."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_fails_without_a_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       env=env, capture_output=True, text=True, cwd=tmp_path,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def _field(rng):
    return rng.normal(0.0, 0.05, (40, 40)).astype(np.float32)


def test_compare_fields_accepts_equal_and_rounding(rng):
    a = _field(rng)
    assert "max|diff|=0.000e+00" in chip_smoke.compare_fields("u", a, a.copy())
    # a few ULP of float32 rounding everywhere stays inside the tolerance
    ulps = np.nextafter(np.nextafter(a, np.inf), np.inf)
    chip_smoke.compare_fields("u", ulps, a)


@pytest.mark.parametrize("how", ["one_cell", "nan", "shape"])
def test_compare_fields_rejects(how, rng):
    a = _field(rng)
    b = a.copy()
    if how == "one_cell":
        # 1e-4 of the largest magnitude on the largest cell: past both the
        # relative (1e-5) and the absolute (1e-5 of the max) tolerance
        i = np.unravel_index(np.abs(a).argmax(), a.shape)
        b[i] += 10 * chip_smoke.FIELD_RTOL * abs(a[i]) + 1e-6
    elif how == "nan":
        b[3, 4] = np.nan
    else:
        b = b[:-1]
    with pytest.raises(AssertionError):
        chip_smoke.compare_fields("u", b, a)


def _state(rng, speed=1.0, damage=0.0, conc=1.0):
    from types import SimpleNamespace

    return SimpleNamespace(
        vt_u=speed * _field(rng), vt_v=speed * _field(rng),
        damage=np.full((40, 40), 0.2 + damage), conc=np.full((40, 40), 0.9 * conc),
        thick=np.full((40, 40), 1.5),
    )


@pytest.mark.parametrize("change,ok", [
    ({}, True),
    ({"speed": 1.0 + 0.5 * chip_smoke.MEAN_SPEED_RTOL}, True),
    ({"speed": 1.0 + 2 * chip_smoke.MEAN_SPEED_RTOL}, False),
    ({"damage": 2 * chip_smoke.MEAN_DAMAGE_ATOL}, False),
    ({"conc": 1.0 + 2 * chip_smoke.VOLUME_RTOL}, False),
])
def test_compare_stats(change, ok):
    want = chip_smoke.state_stats(_state(np.random.default_rng(1)))
    got = chip_smoke.state_stats(_state(np.random.default_rng(1), **change))
    if ok:
        chip_smoke.compare_stats("s", got, want)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.compare_stats("s", got, want)
