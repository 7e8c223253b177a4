"""The port's YAML reader and config tool against PyYAML and the JAX package's.

* `utils.yaml_subset.load` gives ``yaml.safe_load``'s value on every YAML
  file in the repository, on the YAML 1.1 literals the configs and the
  overrides meet, and on what ``yaml.safe_dump`` writes; what
  `utils.yaml_subset.dump` writes ``yaml.safe_load`` reads back equal (a
  hypothesis property, derandomized). Text PyYAML refuses raises
  `YAMLError`; YAML outside the subset raises `UnsupportedYAML`.
* `utils.config_tool`'s override parser, interpolation and `load_config`
  equal JAX's ``eventstreamgpt_tpu/utils/config_tool.py`` on the same
  strings, for each registered config class, under ``unstructure``; the one
  difference, the port's repair of ``config.*`` strings, is stated.
"""

import datetime
import json
import math
from pathlib import Path

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import eventstreamgpt_tpu.utils.config_tool as jax_tool
import eventstreamgpt_tpu_torch.utils.config_tool as tool
from eventstreamgpt_tpu.evaluation import GenerateConfig as JaxGenerateConfig
from eventstreamgpt_tpu.models.config import MetricsConfig as JaxMetricsConfig
from eventstreamgpt_tpu.models.config import OptimizationConfig as JaxOptimizationConfig
from eventstreamgpt_tpu.data import PytorchDatasetConfig as JaxPytorchDatasetConfig
from eventstreamgpt_tpu.training import PretrainConfig as JaxPretrainConfig
from eventstreamgpt_tpu.training.fine_tuning import FinetuneConfig as JaxFinetuneConfig
from eventstreamgpt_tpu_torch.data.config import PytorchDatasetConfig
from eventstreamgpt_tpu_torch.evaluation import GenerateConfig
from eventstreamgpt_tpu_torch.models.config import MetricsConfig, OptimizationConfig
from eventstreamgpt_tpu_torch.training.fine_tuning import FinetuneConfig
from eventstreamgpt_tpu_torch.training.pretrain import PretrainConfig
from eventstreamgpt_tpu_torch.utils import yaml_subset as ys

REPO = Path(__file__).resolve().parents[1]
YAML_FILES = sorted(REPO.glob("configs/**/*.yaml")) + [REPO / "sample_data" / "dataset.yaml"]


def canon(x):
    """A comparable form that tells 1, 1.0 and True apart and NaN from NaN."""
    if isinstance(x, dict):
        return ("dict", [(canon(k), canon(v)) for k, v in x.items()])
    if isinstance(x, list):
        return ("list", [canon(v) for v in x])
    if isinstance(x, float) and math.isnan(x):
        return ("nan",)
    return (type(x).__name__, x)


def pyyaml_or_error(text):
    try:
        return canon(yaml.safe_load(text))
    except yaml.YAMLError:
        return "error"


def port_or_error(text):
    try:
        return canon(ys.load(text))
    except ys.YAMLError:
        return "error"


# --------------------------------------------------------------- the reader
def test_every_yaml_file_is_in_the_sweep():
    names = {p.relative_to(REPO).as_posix() for p in YAML_FILES}
    assert {"configs/pretrain_base.yaml", "configs/parameters/default.yaml", "configs/normalizer_config/standard_scaler.yaml",
            "configs/outlier_detector_config/stddev_cutoff.yaml", "sample_data/dataset.yaml"} <= names  # fmt: skip
    assert len(names) == 8


@pytest.mark.parametrize("path", YAML_FILES, ids=lambda p: p.relative_to(REPO).as_posix())
def test_reads_each_repo_yaml_as_pyyaml_does(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert canon(ys.load_file(path)) == canon(want)


LITERALS = [
    # floats and strings under YAML 1.1's resolver
    "1.0e-2", "1e-3", "1e+3", "1.5e3", "1.0e2", "-.5", ".5", "1.", "1.5e+3", "1_0.5", ".inf", "-.inf", ".NaN", "NaN",
    # booleans and nulls
    "yes", "off", "TRUE", "True", "No", "oN", "y", "~", "null", "Null", "", "# a comment only",
    # integers
    "0x1F", "017", "1_000", "12:30", "190:20:30", "0o17", "0b101", "+12", "-0x1F", "0_", "_1", "-0",
    # timestamps
    "2025-01-14", "2025-01-14 10:00:00", "2025-01-14T10:00:00Z", "2025-01-14 10:00:00.5 +01:00", "2025-1-4 1:00:00",
    # plain strings the configs hold
    "???", "${experiment_dir}/pretrain", "${oc.env:PROJECT_DIR}/data/${cohort_name}", "%m/%d/%Y, %H:%M:%S",
    # collections and the override values of the JAX script tests
    "a: b", "x #c", "- 1", "[10, 20]", "[taskA]", "{}", "[]", '{ "dob": ["timestamp", "%m/%d/%Y"] }',
    '[["global"], ["global", "local"]]', "{a: 1, b}", "[a: 1]", "[a, b,]", "{a:b}", '{"a":b}',
    "defaults:\n  - parameters: default\n  - _self_\n", "key:\n- a\n- b\nz: 1\n", "- - 1\n  - 2\n- x: 1\n  y: 2\n",
    # quoting and folding
    "'it''s'", '"a\\tb\\u00e9\\x41"', 'x: "a\\\n  b"', "x: 'a\n\n  b'", "x: a\n  b\n\n  c\n", "a: 'yes'",
    "'1e-3'", "x: 1\n...\n", "? a\n: b\n",
    # text PyYAML refuses
    "%m/%d", "@x", "`x", "a: b: c", "[,]", ": a", "a:\tb", "=", "a: <<", '"\\q"', "'open", "a: 1\n...\nb",
]  # fmt: skip


@pytest.mark.parametrize("text", LITERALS)
def test_literal_reads_as_pyyaml_reads_it(text):
    assert port_or_error(text) == pyyaml_or_error(text)


def test_named_literals_resolve_as_yaml_1_1():
    assert ys.load("1.0e-2") == 0.01 and isinstance(ys.load("1.0e-2"), float)
    assert [ys.load(s) for s in ("1e-3", "1e+3", "1.5e3", "1.0e2", "-.5", "0o17", "NaN")] == [
        "1e-3", "1e+3", "1.5e3", "1.0e2", "-.5", "0o17", "NaN"]  # fmt: skip
    assert [ys.load(s) for s in ("yes", "off", "TRUE", "True")] == [True, False, True, True]
    assert [ys.load(s) for s in ("~", "null", "Null", "")] == [None] * 4
    assert [ys.load(s) for s in ("0x1F", "017", "1_000", "12:30")] == [31, 15, 1000, 750]
    assert ys.load(".inf") == math.inf
    assert ys.load("2025-01-14") == datetime.date(2025, 1, 14)
    assert ys.load("2025-01-14 10:00:00") == datetime.datetime(2025, 1, 14, 10, 0)
    assert ys.load("a: b") == {"a": "b"} and ys.load("x #c") == "x" and ys.load("- 1") == [1]


@pytest.mark.parametrize(
    "text, construct",
    [("a: &x 1", "anchors"), ("a: *x", "aliases"), ("a: !!str 1", "tags"), ("a: |\n  x\n", "block scalars"),
     ("a: >\n  x\n", "block scalars"), ("---\na: 1\n", "document markers"), ("a: 1\n---\nb: 2\n", "document markers"),
     ("[a]: b", "complex keys"), ("? [a]\n: b\n", "complex keys"), ("<<: {a: 1}", "merge keys"),
     ("x:\n  y: 1\n  z: &a 2\n", "anchors")],
)  # fmt: skip
def test_refused_constructs_raise_naming_the_construct_and_line(text, construct):
    with pytest.raises(ValueError, match=construct) as e:
        ys.load(text)
    assert isinstance(e.value, ys.UnsupportedYAML) and "line " in str(e.value)


def test_refused_constructs_name_their_line():
    with pytest.raises(ys.UnsupportedYAML, match=r"anchors .*line 3"):
        ys.load("x:\n  y: 1\n  z: &a 2\n")


# --------------------------------------------------------------- the writer
def test_writer_floats_read_back_as_floats():
    assert ys.dump({"x": 1e-05}) == "x: 1.0e-05\n"
    assert yaml.safe_load(ys.dump({"x": 1e-05})) == {"x": 1e-05}
    assert yaml.safe_load(json.dumps({"x": 1e-05})) == {"x": "1e-05"}  # JSON's form is a YAML 1.1 string
    assert ys.dump([1e16, -0.0, math.inf, 0.5]) == "- 1.0e+16\n- -0.0\n- .inf\n- 0.5\n"


@pytest.mark.parametrize("s", ["yes", "1e-3", "x: y", "~", "", "12:30", "- a", "a #b", "2025-01-14", "=", "<<", "...",
                               "trail ", "a\nb", "é", "%m/%d"])  # fmt: skip
def test_writer_quotes_strings_that_would_read_otherwise(s):
    text = ys.dump({"k": s})
    assert text != f"k: {s}\n"
    assert yaml.safe_load(text) == {"k": s} and ys.load(text) == {"k": s}
    if s in ("yes", "1e-3", "x: y"):
        assert text == f"k: '{s}'\n"


TRICKY = ["yes", "no", "on", "Off", "TRUE", "~", "null", "1e-3", "1.0e-2", "0x1F", "017", "12:30", "2025-01-14",
          "2025-01-14 10:00:00", "x: y", "a #b", "- a", "[1, 2]", "{a: 1}", "???", "${experiment_dir}/pretrain", "",
          "  lead", "trail  ", "it's", '"q"', "%m/%d", "@x", ".inf", "-.5", "1_000", "<<", "=", "...", "---", "a\nb",
          "a\n\nb", " ", "\t", "é", "#", "a:", ":a", "-", "0o17", "NaN", "1.0", "1"]  # fmt: skip
TEXT = st.one_of(st.sampled_from(TRICKY), st.text(st.characters(exclude_categories=("Cs",)), max_size=90))
SCALARS = st.one_of(st.none(), st.booleans(), st.integers(), st.floats(allow_nan=False), TEXT, st.dates(),
                    st.datetimes())  # fmt: skip
KEYS = st.one_of(TEXT, st.integers(), st.booleans())
DATA = st.recursive(SCALARS, lambda c: st.one_of(st.lists(c, max_size=4), st.dictionaries(KEYS, c, max_size=4)),
                    max_leaves=20)  # fmt: skip


@settings(max_examples=300, deadline=None, derandomize=True, database=None,
          suppress_health_check=list(HealthCheck))  # fmt: skip
@given(st.dictionaries(KEYS, DATA, max_size=6))
def test_round_trips_with_pyyaml(d):
    """What ``yaml.safe_dump`` writes the port reads equal; what the port
    writes ``yaml.safe_load`` and the port read equal."""
    assert ys.load(yaml.safe_dump(d)) == d
    mine = ys.dump(d)
    assert yaml.safe_load(mine) == d
    assert ys.load(mine) == d


def test_reads_pyyaml_dumps_of_a_resolved_pretrain_config():
    cfg = json.loads(json.dumps(jax_tool.unstructure(JaxPretrainConfig()), default=str))
    assert ys.load(yaml.safe_dump(cfg)) == cfg
    assert yaml.safe_load(ys.dump(cfg)) == cfg


# -------------------------------------------------------- the config tool
OVERRIDE_VALUES = ["1e-05", "1.0e-5", "5", "true", "null", "~", "[100, 1000]", "[taskA]", "{}", "%m/%d", "@x",
                   "a: b", "x #c", "- 1", "???", "${experiment_dir}/x", "FULL", "0.5", "'quoted'", "12:30", "",
                   "log_normal_mixture", "[[global], [global, local]]"]  # fmt: skip


@pytest.mark.parametrize("raw", OVERRIDE_VALUES)
def test_parse_override_value_as_jax(raw):
    assert canon(tool.parse_override_value(raw)) == canon(jax_tool.parse_override_value(raw))


def test_unsupported_override_values_raise():
    with pytest.raises(ys.UnsupportedYAML):
        tool.parse_override_value("&a 1")


SCRIPT_OVERRIDES = [
    "data_config.save_dir=/tmp/x", "data_config.max_seq_len=16", "data_config.min_seq_len=2", "config.hidden_size=32",
    "config.head_dim=8", "config.num_attention_heads=4", "config.num_hidden_layers=2", "config.intermediate_size=32",
    "optimization_config.init_lr=1e-3", "optimization_config.max_epochs=1", "optimization_config.batch_size=8",
    "optimization_config.validation_batch_size=8", "optimization_config.lr_frac_warmup_steps=0.5", "save_dir=/tmp/p",
    "do_overwrite=true",
]  # fmt: skip
OVERRIDE_SETS = {
    "script": SCRIPT_OVERRIDES,
    "tilde_plus": ["~optimization_config.patience", "+trainer_config.extra=3", "~seed=4", "config.seq_attention_types=[global, local]"],
    "now": ["experiment_dir=/tmp/run_${now:%Y}", "save_dir=${experiment_dir}/pt"],
    "env": ["experiment_dir=${oc.env:ESGPT_TEST_DIR}", "save_dir=${oc.env:ESGPT_UNSET_DIR,/tmp/dflt}/x"],
    "strings": ["data_config.save_dir=???", "trainer_config.note=%m/%d", "config.structured_event_processing_mode=conditionally_independent"],
}  # fmt: skip


class FrozenDatetime(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return cls(2031, 5, 6, 7, 8, 9)


@pytest.fixture
def frozen(monkeypatch):
    for module in (tool, jax_tool):
        monkeypatch.setattr(module.datetime, "datetime", FrozenDatetime)
    monkeypatch.setenv("ESGPT_TEST_DIR", "/tmp/env_dir")
    monkeypatch.delenv("ESGPT_UNSET_DIR", raising=False)


@pytest.mark.parametrize("name", sorted(OVERRIDE_SETS))
def test_parse_overrides_and_interpolation_as_jax(name, frozen):
    args = OVERRIDE_SETS[name]
    ours, theirs = tool.parse_overrides(args), jax_tool.parse_overrides(args)
    assert canon(ours) == canon(theirs)
    base = {"experiment_dir": "./experiments", "save_dir": "${experiment_dir}/pretrain", "n": {"a": "${save_dir}"}}
    assert tool.resolve_interpolations(tool.deep_merge(dict(base), ours)) == jax_tool.resolve_interpolations(
        jax_tool.deep_merge(dict(base), theirs))  # fmt: skip


CLASSES = [(PretrainConfig, JaxPretrainConfig), (FinetuneConfig, JaxFinetuneConfig), (GenerateConfig, JaxGenerateConfig),
           (OptimizationConfig, JaxOptimizationConfig), (MetricsConfig, JaxMetricsConfig),
           (PytorchDatasetConfig, JaxPytorchDatasetConfig)]  # fmt: skip


@pytest.mark.parametrize("pair", CLASSES, ids=lambda p: p[0].__name__)
def test_classes_register_by_name_as_jax(pair):
    ours, theirs = pair
    name = tool._snake_case(ours.__name__)
    assert tool.CONFIG_STORE[name] is ours and jax_tool.CONFIG_STORE[name] is theirs
    assert tool.unstructure(tool.load_config(name)) == jax_tool.unstructure(jax_tool.load_config(name))


PRETRAIN_CASES = {name: args for name, args in OVERRIDE_SETS.items()}


@pytest.mark.parametrize("yaml_file", [None, "configs/pretrain_base.yaml"])
@pytest.mark.parametrize("name", sorted(PRETRAIN_CASES))
def test_load_pretrain_config_as_jax(name, yaml_file, frozen):
    fp = REPO / yaml_file if yaml_file else None
    ours = tool.load_config(PretrainConfig, yaml_file=fp, overrides=PRETRAIN_CASES[name])
    theirs = jax_tool.load_config(JaxPretrainConfig, yaml_file=fp, overrides=PRETRAIN_CASES[name])
    assert canon(tool.unstructure(ours)) == canon(jax_tool.unstructure(theirs))


@pytest.mark.parametrize(
    "args",
    [["optimization_config.init_lr=1e-3", "optimization_config.batch_size=8", "task_df_name=t"],
     ["task_specific_params.num_samples=2", "task_specific_params.max_new_events=4", "seed=3", "do_overwrite=yes"],
     ["optimization_config.validation_batch_size=8", "data_config_overrides.seq_padding_side=left"]],
)  # fmt: skip
@pytest.mark.parametrize("pair", CLASSES[1:3], ids=lambda p: p[0].__name__)
def test_load_finetune_and_generate_configs_as_jax(pair, args):
    ours = tool.load_config(pair[0], overrides=args)
    theirs = jax_tool.load_config(pair[1], overrides=args)
    assert canon(tool.unstructure(ours)) == canon(jax_tool.unstructure(theirs))


def test_subset_sizes_override_loads_as_jax():
    from scripts.build_dataset import load_yaml_with_defaults as jax_load_with_defaults

    args = ["initial_model_path=/tmp/i", "subset_sizes='[100, 1000]'", "seeds=2"]
    fp = REPO / "configs" / "pretrain_subsets_base.yaml"
    ours = tool.resolve_interpolations(tool.deep_merge(tool.load_yaml_with_defaults(fp), tool.parse_overrides(args)))
    theirs = jax_tool.resolve_interpolations(jax_tool.deep_merge(jax_load_with_defaults(fp), jax_tool.parse_overrides(args)))
    assert canon(ours) == canon(theirs)
    assert ours["subset_sizes"] == "[100, 1000]"  # quoted: a string, in both
    sweep = REPO / "configs" / "hyperparameter_sweep_base.yaml"
    assert canon(tool.load_yaml_with_defaults(sweep)) == canon(jax_load_with_defaults(sweep))


def test_config_float_repair():
    """JAX hands ``config.resid_dropout=1e-05`` (a YAML 1.1 string) to the
    model as a string; the port coerces it to the annotated float. Other
    entries are as JAX's."""
    args = ["config.resid_dropout=1e-05", "config.hidden_size=32", "config.precision=bf16", "config.head_dim=8"]
    theirs = jax_tool.load_config(JaxPretrainConfig, overrides=args)
    ours = tool.load_config(PretrainConfig, overrides=args)
    assert theirs.config["resid_dropout"] == "1e-05" and ours.config["resid_dropout"] == "1e-05"
    assert theirs.build_model_config().resid_dropout == "1e-05"
    built = ours.build_model_config()
    assert built.resid_dropout == 1e-05 and isinstance(built.resid_dropout, float)
    assert (built.hidden_size, built.precision, built.head_dim) == (32, "bf16", 8)


def test_coerce_to_signature_keeps_what_does_not_convert():
    from eventstreamgpt_tpu_torch.models.config import StructuredTransformerConfig

    out = tool.coerce_to_signature(StructuredTransformerConfig.__init__,
                                   {"resid_dropout": "1e-05", "head_dim": "64", "hidden_size": "x", "precision": "bf16",
                                    "unknown": "1e-5", "scan_layers": "true", "attention_dropout": 0})  # fmt: skip
    assert out == {"resid_dropout": 1e-05, "head_dim": 64, "hidden_size": "x", "precision": "bf16", "unknown": "1e-5",
                   "scan_layers": True, "attention_dropout": 0}  # fmt: skip
