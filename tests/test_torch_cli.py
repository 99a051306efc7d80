"""``python -m demuxalot_tpu_torch`` against ``python -m demuxalot_tpu`` on one BAM.

Both CLIs run in-process on the JAX package's synthetic BAM (3 donors, 50
barcodes, two 1,000 bp chromosomes); the port with ``--device cpu``. The
files they write must hold the same assignments; posteriors within 1e-5,
counts exactly.
"""
import numpy as np
import pandas as pd
import pytest

from demuxalot_tpu.cli import main as jax_main
from demuxalot_tpu.frontend.snp_counter import load_snp_counts as jax_load_snp_counts
from demuxalot_tpu.sim import generate_bam_file
from demuxalot_tpu_torch.cli import main
from demuxalot_tpu_torch.frontend import load_snp_counts
from demuxalot_tpu_torch.models.demux import Demultiplexer


@pytest.fixture(scope="module")
def cli_problem(tmp_path_factory):
    np.random.seed(11)
    root = tmp_path_factory.mktemp("cli")
    bam, genotypes, _ids, names = generate_bam_file(
        str(root / "sample.bam"), n_genotypes=3, doublets_fraction=0.1, mutation_prob=0.03,
        n_barcodes=50, n_reads_per_barcode=40, chromosome2length={"chr1": 1000, "chr2": 1000},
    )
    barcodes = root / "barcodes.csv"
    barcodes.write_text("\n".join(names) + "\n")
    betas = root / "prior_betas.parquet"
    genotypes.save_betas(str(betas))
    return bam, str(barcodes), str(betas)


def _run_both(cli_problem, tmp_path, *flags):
    """Output directories of the port's and the JAX CLI's ``demux`` with ``flags``."""
    bam, barcodes, betas = cli_problem
    common = ["demux", "--bam", bam, "--barcodes", barcodes, "--prior-betas", betas, "--jobs", "1", *flags]
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    assert main([*common, "--output-dir", str(ours), "--device", "cpu"]) == 0
    assert Demultiplexer.device == "cuda", "the CLI restores the engine's device"
    assert jax_main([*common, "--output-dir", str(theirs)]) == 0
    return ours, theirs


def _csv(path):
    return pd.read_csv(path, index_col=0)


@pytest.mark.parametrize("damping", [None, "auto"])
def test_demux_refine_matches_jax(cli_problem, tmp_path, damping):
    flags = ["--n-iterations", "2", "--doublet-prior", "0.25"] + (["--damping", damping] if damping else [])
    ours, theirs = _run_both(cli_problem, tmp_path, *flags)
    assert sorted(p.name for p in ours.iterdir()) == sorted(p.name for p in theirs.iterdir()) == [
        "assignments.csv", "learnt_betas.parquet", "posteriors.csv"]
    a, b = _csv(ours / "assignments.csv"), _csv(theirs / "assignments.csv")
    assert list(a.index) == list(b.index) and list(a.columns) == list(b.columns)
    assert (a["assignment"] == b["assignment"]).all()
    np.testing.assert_allclose(a["posterior"], b["posterior"], atol=1e-5)
    np.testing.assert_allclose(_csv(ours / "posteriors.csv").values, _csv(theirs / "posteriors.csv").values,
                               atol=1e-5)
    learnt, jax_learnt = (pd.read_parquet(d / "learnt_betas.parquet") for d in (ours, theirs))
    assert list(learnt.index) == list(jax_learnt.index) and list(learnt.columns) == list(jax_learnt.columns)
    np.testing.assert_allclose(learnt.values, jax_learnt.values, rtol=1e-4, atol=1e-2)


def test_demux_no_refine_matches_jax(cli_problem, tmp_path):
    ours, theirs = _run_both(cli_problem, tmp_path, "--no-refine")
    for name in ("assignments.csv", "posteriors.csv", "logits.csv"):
        a, b = _csv(ours / name), _csv(theirs / name)
        assert list(a.columns) == list(b.columns) and list(a.index) == list(b.index)
    assert (_csv(ours / "assignments.csv")["assignment"] == _csv(theirs / "assignments.csv")["assignment"]).all()
    np.testing.assert_allclose(_csv(ours / "logits.csv").values, _csv(theirs / "logits.csv").values,
                               rtol=1e-4, atol=5e-3)


@pytest.mark.parametrize("refine", [False, True])
def test_demux_compact_matches_jax(cli_problem, tmp_path, refine):
    flags = ["--compact", "--doublet-prior", "0.25"] + (["--n-iterations", "2"] if refine else ["--no-refine"])
    ours, theirs = _run_both(cli_problem, tmp_path, *flags)
    assert not (ours / "posteriors.csv").exists()
    a, b = _csv(ours / "assignments.csv"), _csv(theirs / "assignments.csv")
    assert list(a.columns) == list(b.columns) == ["assignment", "runner_up", "logit_margin", "posterior"]
    assert (a["assignment"] == b["assignment"]).all()
    np.testing.assert_allclose(a["posterior"], b["posterior"], atol=1e-5)
    np.testing.assert_allclose(a["logit_margin"], b["logit_margin"], rtol=1e-4, atol=5e-3)


def test_count_matches_jax(cli_problem, tmp_path):
    bam, barcodes, betas = cli_problem
    common = ["count", "--bam", bam, "--barcodes", barcodes, "--prior-betas", betas, "--jobs", "1"]
    assert main([*common, "--counts-dir", str(tmp_path / "ours")]) == 0
    assert jax_main([*common, "--counts-dir", str(tmp_path / "theirs")]) == 0
    ours, theirs = load_snp_counts(tmp_path / "ours"), jax_load_snp_counts(tmp_path / "theirs")
    assert sorted(ours) == sorted(theirs) == ["chr1", "chr2"]
    for chromosome in ours:
        assert ours[chromosome].molecules.tobytes() == theirs[chromosome].molecules.tobytes()
        assert ours[chromosome].snp_calls.tobytes() == theirs[chromosome].snp_calls.tobytes()


def test_counts_cache_rejects_changed_inputs(cli_problem, tmp_path):
    bam, barcodes, betas = cli_problem
    cache = tmp_path / "cache"
    base = ["--bam", bam, "--prior-betas", betas, "--no-refine", "--counts-cache", str(cache),
            "--device", "cpu", "--jobs", "1"]
    assert main(["demux", "--barcodes", barcodes, "--output-dir", str(tmp_path / "out1"), *base]) == 0
    assert (cache / "manifest.json").exists()
    shorter = tmp_path / "shorter.csv"
    shorter.write_text("".join(open(barcodes).readlines()[:-1]))
    with pytest.raises(SystemExit, match="different inputs"):
        main(["demux", "--barcodes", str(shorter), "--output-dir", str(tmp_path / "out2"), *base])
    # the cache is reused when the inputs match
    assert main(["demux", "--barcodes", barcodes, "--output-dir", str(tmp_path / "out3"), *base]) == 0
    pd.testing.assert_frame_equal(_csv(tmp_path / "out1" / "posteriors.csv"),
                                  _csv(tmp_path / "out3" / "posteriors.csv"))


@pytest.mark.parametrize("refine", [False, True])
def test_demux_sharded_writes_the_same_assignments(cli_problem, tmp_path, capsys, refine):
    """``demux --sharded --compact --device cpu`` (one CPU shard) against the run without ``--sharded``."""
    bam, barcodes, betas = cli_problem
    common = ["demux", "--bam", bam, "--barcodes", barcodes, "--prior-betas", betas, "--jobs", "1", "--compact",
              "--doublet-prior", "0.25", "--device", "cpu"] + (["--n-iterations", "2"] if refine else ["--no-refine"])
    assert main([*common, "--output-dir", str(tmp_path / "single")]) == 0
    capsys.readouterr()
    assert main([*common, "--sharded", "--output-dir", str(tmp_path / "sharded")]) == 0
    assert "# sharding over 1 devices" in capsys.readouterr().err
    assert Demultiplexer.device == "cuda", "the CLI restores the engine's device"
    a, b = _csv(tmp_path / "sharded" / "assignments.csv"), _csv(tmp_path / "single" / "assignments.csv")
    assert list(a.index) == list(b.index) and list(a.columns) == list(b.columns)
    assert (a["assignment"] == b["assignment"]).all()
    np.testing.assert_allclose(a["posterior"], b["posterior"], atol=1e-5)
    if refine:
        learnt, single = (pd.read_parquet(tmp_path / d / "learnt_betas.parquet") for d in ("sharded", "single"))
        np.testing.assert_allclose(learnt.values, single.values, rtol=1e-5, atol=1e-5)


def _flags(parser, command: str) -> set:
    sub = parser._subparsers._group_actions[0].choices[command]
    return {option for action in sub._actions for option in action.option_strings}


def test_demux_flags_are_the_jax_flags(capsys):
    from demuxalot_tpu.cli import build_parser as jax_build_parser
    from demuxalot_tpu_torch.cli import build_parser

    assert _flags(build_parser(), "demux") == _flags(jax_build_parser(), "demux") | {"--device"}
    with pytest.raises(SystemExit) as error:
        main(["demux", "--help"])
    assert error.value.code == 0
    assert "--sharded" in capsys.readouterr().out


def test_detect_snps_help_lists_the_jax_flags(capsys):
    from demuxalot_tpu.cli import build_parser as jax_build_parser
    from demuxalot_tpu_torch.cli import build_parser

    assert _flags(build_parser(), "detect-snps") == _flags(jax_build_parser(), "detect-snps") | {"--device"}
    with pytest.raises(SystemExit) as error:
        main(["detect-snps", "--help"])
    assert error.value.code == 0
    usage = capsys.readouterr().out
    for flag in ("--out", "--min-coverage", "--min-alternative-fraction", "--min-alternative-coverage",
                 "--best-per-donor", "--additional-best", "--bam", "--barcodes", "--device"):
        assert flag in usage


def test_parse_bam_forms(tmp_path):
    from demuxalot_tpu_torch.cli import _parse_bam

    plain = tmp_path / "sample.bam"
    plain.touch()
    weird = tmp_path / "run=2.bam"  # '=' inside a real path
    weird.touch()
    assert _parse_bam([str(plain)]) == str(plain)
    assert _parse_bam([str(weird)]) == str(weird)
    assert _parse_bam([f"L1={plain}"]) == {"L1": str(plain)}
    assert _parse_bam(["L1=missing.bam"]) == "L1=missing.bam"
    assert _parse_bam([f"A={plain}", f"B={weird}"]) == {"A": str(plain), "B": str(weird)}
    with pytest.raises(SystemExit, match="RG=PATH"):
        _parse_bam([str(plain), "second.bam"])
