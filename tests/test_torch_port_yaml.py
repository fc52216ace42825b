"""The port's YAML reader (``core/yaml_subset.py``) against PyYAML's
``yaml.safe_load``, which the JAX package reads its configs with.

Equality is strict: the same keys in the same order, and each value of the
same type (``True`` is not ``1``) and value (NaN matches NaN). Covered:
every file under ``configs/``, the YAMLs the tests write with
``yaml.safe_dump``, a table of edge scalars, a hypothesis property over
nested mappings dumped by ``yaml.safe_dump`` in block and flow style, and
each unsupported construct raising ``ValueError`` with its line number,
PyYAML's own edge cases (a byte-order mark, tabs, a sequence entry after a
key, the document end marker) and BOM-prefixed configs through both
``load_config``s.
"""

import dataclasses
import glob
import math
import os

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from megaportraits_tpu.core import config as jconfig

from megaportraits_tpu_torch.core import config as tconfig
from megaportraits_tpu_torch.core.yaml_subset import load, load_file

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml")))


def same(a, b):
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def check(text):
    want = yaml.safe_load(text)
    got = load(text)
    assert same(got, want), (text, got, want)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_every_config_reads_as_pyyaml_reads_it(path):
    assert same(load_file(path), yaml.safe_load(open(path)))


def test_the_tests_written_configs():
    """What ``test_torch_port_parallel._driver_yaml`` and the drivers'
    tests write: nested mappings, paths, None, a flow-sized mesh."""
    for mesh in (None, {"data": 2}, {"data": 1, "model": 2}):
        cfg = {"data": {"train_width": 64, "train_height": 64},
               "model": {"arch": "tiny", "use_bf16": False},
               "training": dict(video_dir="/tmp/pytest-of-x/clips0",
                                json_file="/tmp/pytest-of-x/clips0/meta.json",
                                checkpoint_path="/tmp/x/ckpt", batch_size=2,
                                n_sample_frames=4, use_bf16=False, mesh_shape=mesh,
                                log_interval=1, save_interval=2, lr=1.0e-5,
                                remat=None)}
        for style in (False, None, True):
            check(yaml.safe_dump(cfg, default_flow_style=style))


EDGE_SCALARS = [
    "1e-5", "1.0e-5", "1.0e5", "1.0E+5", "-1.5e+3", "12e3", "1.", ".5", "-.5", "+1.5",
    "1_000.5", "190:20:30.15", ".inf", "-.inf", "+.inf", ".Inf", ".NaN", ".nan", "NaN",
    "0", "-0", "+1", "007", "08", "0x1F", "-0x1f", "0b101", "1_000", "1:30", "0o17",
    "yes", "Yes", "YES", "no", "on", "Off", "true", "False", "y", "n", "TRUE", "tRue",
    "~", "null", "Null", "NULL", "", "nil", "none",
    "'it''s'", "'yes'", '"on"', '"a\\tb\\u00e9\\x41\\\\"', "'#not a comment'",
    "a b # comment", "a#b", "http://x.y/z", "a:b", "-x", "--", "./junk", "'a: b'",
    "'multi\n  line'", '"fold\n\n  ed"', '"esc\\\n  aped"', "plain\n  two\n  lines",
]


@pytest.mark.parametrize("scalar", EDGE_SCALARS)
def test_edge_scalars(scalar):
    check(f"key: {scalar}\n")


def test_structures():
    check("a:\n- 1\n- two\nb: 3\n")          # a sequence at its key's indent
    check("a:\n    - 1\n    -\n    - x  # c\n")
    check("# head\n\na:  # c\n  b:\n    c: [1, [2, 3], {d: e}]\n  f: {}\n\ng: []\n")
    check("- a\n- 'b'\n- [1, 2]\n")
    check("42\n")
    check("")
    check("# only a comment\n")
    check("---\na: 1\n")
    check("2: one\nyes: two\n~: three\n'x y': 4\n\"q\": 5\n")
    check("a: {x: 1, y: ,}\n".replace(" ,", " 2,"))
    check("a: [1, 2, ]\n")
    check("a: [1,\n  'two\n  lines', {b: c,  # comment\n   d: e}]\nf: 1\n")


UNSUPPORTED = [
    ("a: 1\nb: &anchor 2\n", 2, "anchors"),
    ("a: 1\nb: *alias\n", 2, "aliases"),
    ("a: !!str 1\n", 1, "tags"),
    ("a: 1\nb: |\n  text\n", 2, "block scalars"),
    ("a: >\n  text\n", 1, "block scalars"),
    ("a: 1\n---\nb: 2\n", 2, "several documents"),
    ("a: 1\n...\nb: 2\n", 3, "several documents"),
    ("a: 1\nb:\n  c: 2\n  c: 3\n", 4, "duplicate key"),
    ("a: {x: 1, x: 2}\n", 1, "duplicate key"),
    ("a:\n  - x: 1\n", 2, "mapping inside a block sequence"),
    ("a:\n  - - 1\n", 2, "sequence inside a block sequence"),
    ("? a\n: b\n", 1, "complex keys"),
    ("%YAML 1.1\n---\na: 1\n", 1, "directives"),
    ("a: 1\nb: 2001-12-14\n", 2, "dates"),
    ("a: [1,\n2]\n", 2, "not indented"),
    ("a:\n\tb: 1\n", 2, "tabs"),
    ("<<: {a: 1}\n", 1, "merge keys"),
    ("a: b: c\n", 1, "mapping value"),
    ("a: 1\n   b: 2\n", 2, "bad indentation"),
    ("{a: 1}: 2\n", 1, "flow collections as keys"),
    ("a: 'open\n", 1, "unterminated"),
    ('a: "\\q"\n', 1, "unknown escape"),
]


@pytest.mark.parametrize("text,line,what", UNSUPPORTED, ids=[u[2] for u in UNSUPPORTED])
def test_unsupported_raises_with_its_line(text, line, what):
    with pytest.raises(ValueError, match=f"line {line}: .*{what}"):
        load(text)


# PyYAML's edge cases: a leading byte-order mark is dropped (a later one is
# kept), a tab outside quotes and comments raises, a '- ' entry cannot be a
# key's value on its line, and '...' may end the document.
PYYAML_EDGES = [
    "\ufeffdata:\n  train_width: 256\n", "\ufeff# c\na: 1\n", "a: 1\n\ufeffb: 2\n",
    "a:\tb\n", "a: b\t\n", "a:\t# c\n", "- \tx\n", "a: 1\n\t\nb: 2\n", "a: [1,\t2]\n",
    "x: \"a\tb\"\n", "x: 'a\tb'\n", "x: 'it''s\tok'\n", "a: 1  # c\td\n",
    "x: \"multi\n  li\tne\"\n",
    "a: - x\n", "a:  - x\n", "a: -x\n", "a: b - x\n",
    "a: 1\n...\n", "a: 1\n...", "a: 1\n... # c\n# d\n\n", "a: 1\n...\n...\n",
    "a:\n  - 1\n...\n", "---\na: 1\n...\n", "---\n...\n", "a: 1\n ...\n",
    "a: 1\n...\nb: 2\n", "a: 1\n...\n---\nb: 2\n", "...\n", "# c\n...\n",
]


@pytest.mark.parametrize("text", PYYAML_EDGES)
def test_pyyaml_edge_cases(text):
    """Read as PyYAML reads it, or raise with a line where PyYAML raises."""
    try:
        yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(ValueError, match=r"line \d+: "):
            load(text)
        return
    check(text)


_TEXT = st.text(alphabet=st.sampled_from(
    list("abcXYZ019 _-.:#'\"/,[]{}!&*%@?|>~=\\\t") + ["é", "✓"]), max_size=12)
_KEY = st.one_of(st.text(alphabet="abcdefgh_", min_size=1, max_size=8), _TEXT,
                 st.integers(-5, 5))
_SCALAR = st.one_of(
    st.none(), st.booleans(), st.integers(-2 ** 40, 2 ** 40),
    st.floats(allow_nan=True, allow_infinity=True), _TEXT)
_TREE = st.recursive(
    st.dictionaries(_KEY, _SCALAR, max_size=4),
    lambda inner: st.dictionaries(
        _KEY, st.one_of(_SCALAR, inner, st.lists(_SCALAR, max_size=4)), max_size=4),
    max_leaves=12)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=_TREE, style=st.sampled_from([False, None, True]))
def test_property_safe_dump_round_trip(tree, style):
    text = yaml.safe_dump(tree, default_flow_style=style)
    want = yaml.safe_load(text)
    try:
        got = load(text)
    except ValueError as e:
        # Only what the reader names as unsupported may raise.
        assert "not supported" in str(e), (text, e)
        return
    assert same(got, want), (text, got, want)


# -- load_config -------------------------------------------------------------------


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_reads_through_the_subset(path, monkeypatch):
    """load_config goes through the reader (PyYAML blocked) and gives JAX's
    Config, field for field."""
    import sys

    want = dataclasses.asdict(jconfig.load_config(path))
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = dataclasses.asdict(tconfig.load_config(path))
    assert got == want


def test_load_config_sets_use_chain_kernel_and_filters_like_jax(tmp_path):
    path = tmp_path / "cfg.yaml"
    path.write_text("model:\n  arch: tiny\n  use_chain_kernel: true\n  unknown_key: 3\n"
                    "training:\n  lr: 1e-5\n  batch_size: 2\n")
    got = tconfig.load_config(str(path))
    want = jconfig.load_config(str(path))
    # use_chain_kernel, a key older configs wrote, is dropped like any other
    # unknown key.
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert not hasattr(got.model, "use_chain_kernel")
    assert got.model.arch == want.model.arch == "tiny"
    # PyYAML's rule, kept: '1e-5' is a string in both packages.
    assert got.training.lr == want.training.lr == "1e-5"
    assert got.training.batch_size == 2


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_bom_prefixed_config_reads_as_the_plain_one(path, tmp_path):
    """A config saved with a UTF-8 byte-order mark: the same dict as the
    plain file, and the same Config through the port's and JAX's
    load_config."""
    bom = tmp_path / os.path.basename(path)
    bom.write_bytes(b"\xef\xbb\xbf" + open(path, "rb").read())
    assert same(load_file(str(bom)), load_file(path))
    got = dataclasses.asdict(tconfig.load_config(str(bom)))
    assert got == dataclasses.asdict(jconfig.load_config(str(bom)))
    assert got == dataclasses.asdict(jconfig.load_config(path))


@pytest.mark.parametrize("head", ["", "# a comment first\n"])
def test_bom_prefixed_config_keeps_its_first_section(head, tmp_path):
    """The first key is not at its default, so dropping it would show."""
    text = head + "data:\n  train_width: 256\ntraining:\n  batch_size: 3\n"
    bom = tmp_path / "bom.yaml"
    bom.write_bytes(b"\xef\xbb\xbf" + text.encode())
    got = tconfig.load_config(str(bom))
    want = jconfig.load_config(str(bom))
    assert got.data.train_width == want.data.train_width == 256
    assert got.data.train_width != tconfig.Config().data.train_width
    assert got.training.batch_size == want.training.batch_size == 3
