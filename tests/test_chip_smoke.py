"""``chip_smoke.py``'s phases at a tiny size on the CPU, and the
compile-cache helper every entry point calls."""

import json

import jax
import numpy as np
import pytest

import chip_smoke
from genome_weaver_align.utils import compile_cache


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_main_refuses_without_gpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_make_genome_is_seeded_with_a_repeat_block():
    a = chip_smoke.make_genome(20_000, seed=3)
    assert a.shape == (20_000,) and a.dtype == np.uint8 and a.max() <= 3
    assert np.array_equal(a, chip_smoke.make_genome(20_000, seed=3))
    assert np.array_equal(a[:300], a[300:600])  # the tandem unit repeats


def test_verify_inputs_shapes_and_planting():
    reads, lengths, wins = chip_smoke.verify_inputs(512, 100, 2, seed=4)
    assert reads.shape == (512, 100) and wins.shape == (512, 106)
    assert reads.dtype == wins.dtype == np.int8 and lengths.dtype == np.int32
    assert lengths.min() >= 50 and lengths.max() == 100
    host = chip_smoke.host_oracle_dist(reads, lengths, wins, 2)
    assert (host <= 2).sum() > 100  # the planted half is mostly within k


def test_verify_phase_on_cpu(capsys):
    chip_smoke.verify_phase(256, iters=1)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("verify:")]
    assert len(lines) == len(chip_smoke.VERIFY_CASES)
    rec = json.loads(lines[0].split(": ", 1)[1])
    assert rec["engine"] == "jnp" and rec["lanes"] == 256


def test_index_and_align_phases_tiny(tmp_path, capsys):
    """The CLI path end to end: index, simulate, align twice (the second
    run compiles nothing), truth and host-oracle checks, memory analysis."""
    ix = chip_smoke.index_phase(tmp_path, 200_000)
    out = chip_smoke.align_phase(tmp_path, ix, 512, 256, min_frac=0.9, oracle_reads=64)
    assert out["sam"].exists()
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("align:")][0]
    rec = json.loads(line.split(": ", 1)[1])
    assert rec["compiles_steady"] == 0 and rec["oracle_rechecked"] == 64
    assert rec["mapped"] >= 0.99 and rec["step_argument_bytes"] > 0


def test_check_truth_and_oracle():
    codes = np.random.default_rng(0).integers(0, 4, size=400, dtype=np.uint8)
    from genome_weaver_align.utils import dna

    seq = dna.decode(codes[100:130])
    rec = ["r0_p100_s0_m0_i0_d0", "0", "chrS", "101", "37", "30M", "*", "0", "0",
           seq, "*", "NM:i:0"]
    unm = ["r1_p5_s1_m0_i0_d0", "4", "*", "0", "0", "*", "*", "0", "0", seq, "*"]
    assert chip_smoke.check_truth([rec, unm], 2) == (0.5, 0.5)
    assert chip_smoke.check_oracle([unm, rec], codes, 2, 1) == 1
    bad = rec[:11] + ["NM:i:1"]
    with pytest.raises(AssertionError, match="host oracle"):
        chip_smoke.check_oracle([bad], codes, 2, 1)


@pytest.fixture
def restore_cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable()
    assert path == str(chip_smoke.ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_leaves_env_dir_to_jax(monkeypatch, tmp_path, restore_cache_config):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir is None  # nothing set in code
