"""The port's LibSVM reader (data/libsvm.py with native/libsvm_parser.cc)
against the JAX package's `read_libsvm` on the same files: the native and
Python routes, with and without the intercept and `num_features`, 0- or
1-based indices, comments and blank lines, a file the native parser
refuses, malformed files, and a `write_libsvm` round trip."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from photon_ml_tpu.data import libsvm as jax_libsvm
from photon_ml_tpu.native import libsvm_parser as jax_native
from photon_ml_tpu_torch.data import libsvm
from photon_ml_tpu_torch.native import libsvm_parser

REPO = Path(__file__).resolve().parent.parent

HAND = """# a comment line
+1 3:0.5 1:2 7:-1e-3   # trailing comment
-1 2:1

-1 5:2.5 6:1
1 1:1 4:0.25
"""


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("libsvm")
    subprocess.run([sys.executable, str(REPO / "examples" / "generate_dataset.py"), str(root),
                    "--train", "300", "--test", "100", "--entities", "5"],
                   check=True, capture_output=True, timeout=120)
    (root / "hand.libsvm").write_text(HAND)
    (root / "zero.libsvm").write_text("1 0:1 2:3\n0 1:2\n")
    (root / "counts.libsvm").write_text("3 1:1 2:2\n0 2:1\n7 1:0.5\n")
    return root


def _read_both(path, route, monkeypatch, **kw):
    """Both packages' readers on `path`; the Python route is each reader's
    route when its native parser declines the file."""
    if route == "python":
        monkeypatch.setattr(jax_native, "parse_file", lambda *a, **k: None)
        monkeypatch.setattr(libsvm_parser, "parse_file", lambda *a, **k: None)
    return libsvm.read_libsvm(path, **kw), jax_libsvm.read_libsvm(path, **kw)


def _same(ours, theirs):
    for f in ("indptr", "indices", "values", "labels"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert ours.dim == theirs.dim


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("name,kw", [
    ("train.libsvm", {}),
    ("train.libsvm", dict(add_intercept=False)),
    ("test.libsvm", dict(num_features=100)),
    ("hand.libsvm", {}),
    ("hand.libsvm", dict(num_features=4, add_intercept=False)),
    ("zero.libsvm", dict(zero_based=True)),
    ("counts.libsvm", dict(dtype=np.float64)),
])
def test_read_libsvm_matches_jax(files, route, name, kw, monkeypatch):
    _same(*_read_both(str(files / name), route, monkeypatch, **kw))


def test_both_routes_give_the_same_arrays(files, monkeypatch):
    path = str(files / "train.libsvm")
    assert libsvm_parser.parse_file(path) is not None
    native = libsvm.read_libsvm(path)
    monkeypatch.setattr(libsvm_parser, "parse_file", lambda *a, **k: None)
    _same(native, libsvm.read_libsvm(path))


def test_a_file_the_native_parser_refuses_goes_where_the_jax_reader_sends_it(files):
    """A label Python's float() takes and strtod does not ("1_0") is refused
    by the native parser; the JAX reader hands such a file to its Python
    tokenizer, and so does the port."""
    path = files / "underscore.libsvm"
    path.write_text("1_0 1:1\n-1 2:1\n")
    assert libsvm_parser.parse_file(str(path)) is None
    _same(libsvm.read_libsvm(str(path)), jax_libsvm.read_libsvm(str(path)))


@pytest.mark.parametrize("text", ["1 1:\n", "1 1 2\n", "x 1:1\n", "1 1:0x10\n", "1 a:1\n"])
def test_malformed_files_raise_as_in_the_jax_reader(files, text):
    path = files / "bad.libsvm"
    path.write_text(text)
    assert libsvm_parser.parse_file(str(path)) is None
    with pytest.raises(ValueError) as theirs:
        jax_libsvm.read_libsvm(str(path))
    with pytest.raises(type(theirs.value)) as ours:
        libsvm.read_libsvm(str(path))
    assert str(ours.value) == str(theirs.value)


def test_a_missing_file_raises(files):
    with pytest.raises(FileNotFoundError):
        libsvm.read_libsvm(str(files / "missing.libsvm"))


def test_write_libsvm_round_trips_and_matches_the_jax_writer(files, tmp_path):
    data = libsvm.read_libsvm(str(files / "train.libsvm"), add_intercept=False,
                              binary_labels_to_01=False)
    libsvm.write_libsvm(str(tmp_path / "ours.libsvm"), data)
    jax_libsvm.write_libsvm(str(tmp_path / "theirs.libsvm"), jax_libsvm.read_libsvm(
        str(files / "train.libsvm"), add_intercept=False, binary_labels_to_01=False))
    assert (tmp_path / "ours.libsvm").read_text() == (tmp_path / "theirs.libsvm").read_text()
    _same(libsvm.read_libsvm(str(tmp_path / "ours.libsvm"), add_intercept=False,
                             binary_labels_to_01=False), data)
    libsvm.write_libsvm(str(tmp_path / "zero.libsvm"), data, zero_based=True)
    _same(libsvm.read_libsvm(str(tmp_path / "zero.libsvm"), add_intercept=False, zero_based=True,
                             binary_labels_to_01=False), data)
    assert np.array_equal(data.to_dense(), jax_libsvm.read_libsvm(
        str(files / "train.libsvm"), add_intercept=False, binary_labels_to_01=False).to_dense())
