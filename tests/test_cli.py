"""CLI surface details: version, reference-flag acceptance, error paths."""

import pytest

from fedrann_jax import __version__
from fedrann_jax.cli import build_parser, config_from_args, main


def test_version_flag(capsys):
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args(["--version"])
    assert e.value.code == 0
    assert __version__ in capsys.readouterr().out


def test_reference_flags_accepted():
    """Every reference CLI flag (fedrann/__main__.py:69-171) must parse."""
    config = config_from_args([
        "-i", "in.fa", "-o", "out", "-k", "15",
        "--kmer-sample-fraction", "0.05", "--kmer-min-multiplicity", "2",
        "--threads", "4", "--chunk-size", "1000",
        "-n", "500", "--nndescent-n-trees", "300",
        "--nndescent-n-neighbors", "50", "--seed", "356115",
        "--save-feature-matrix", "--keep-intermediates", "--mprof",
    ])
    assert config.kmer_size == 15
    assert config.n_trees == 300
    assert config.save_feature_matrix and config.mprof


def test_missing_input_file_fails_cleanly(tmp_path):
    with pytest.raises((FileNotFoundError, ValueError, RuntimeError)):
        main(["-i", str(tmp_path / "nope.fasta"), "-o", str(tmp_path / "o"),
              "--length-buckets", "2048"])


def test_empty_input_fails_cleanly(tmp_path):
    p = tmp_path / "empty.fasta"
    p.write_text(">only_header_no_bases\n")
    with pytest.raises(ValueError):
        main(["-i", str(p), "-o", str(tmp_path / "o"),
              "--length-buckets", "2048", "-k", "11"])


def test_bad_flag_value_rejected():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["-i", "x", "-o", "y",
                                   "--knn-precision", "fp64"])
