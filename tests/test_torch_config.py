"""The port's config composition against the JAX package's, on the CPU.

``bifold_tpu_torch.config.compose`` over the port's conf directory must give
the tree ``bifold_tpu.config.compose`` gives over the JAX package's, for
group overrides, ``dataset@target`` remapping, value overrides, ``+k=v``,
``~k``, ``${oc.env:...}`` interpolation and the errors of a missing option
or an interpolation cycle; ``override_dirname`` must name the run dir the
same; the conf files must hold the same values; the YAML snapshot must be
the same text. (Both packages read YAML with PyYAML.)
"""

from pathlib import Path

import pytest

from bifold_tpu import config as jax_config
from bifold_tpu.__main__ import override_dirname as jax_override_dirname
from bifold_tpu_torch import config
from bifold_tpu_torch.__main__ import override_dirname

ROOT = Path(__file__).resolve().parent.parent

OVERRIDE_SETS = [
    [],
    ["model=siglip"],
    ["train_dataset=synthetic"],
    ["train_dataset=synthetic", "test_dataset=synthetic", "model=siglip",
     "optim=adamw", "scheduler=linear_warmup", "loss=composed"],
    ["dataset@train_dataset=single_sequential", "dataset@test_dataset=real"],
    ["optim.lr=3e-4", "batch_size=8", "model.depth=2", "processor.sigma=2.5"],
    ["+extra.flag=true", "+extra.rate=1e-3", "+extra.name=run"],
    ["~mesh.ep", "~precast_frozen", "~metrics.tracked_metric"],
    ["run_dir=${oc.env:BIFOLD_TEST_CONFIG_ROOT,/fallback}/runs",
     "+here=${oc.env:BIFOLD_TEST_CONFIG_SET}"],
    ["train_dataset=synthetic", "train_dataset.image_size=384",
     "train_dataset.is_bimanual=true", "train_dataset.max_context_length=3",
     "model=siglip_sequential", "use_wandb=true", "log_every=1"],
    # the CLIP families, as chip_smoke.py composes them
    ["model=rgb_clip", "train_dataset=synthetic", "train_dataset.image_size=384",
     "train_dataset.is_bimanual=true", "test_dataset=null"],
    ["model=text_unet", "train_dataset=synthetic", "train_dataset.image_size=384",
     "train_dataset.is_bimanual=true", "model.features=[8,16,32]"],
    # its T5 branch by registry name and by a local dir; data parallelism
    ["model=text_unet", "model.text_encoder=t5-base", "train_dataset=synthetic"],
    ["model=text_unet", "model.text_encoder=google/flan-t5-base"],
    ["model=text_unet", "model.text_encoder=/ckpt/tiny-t5", "test_dataset=synthetic"],
    ["mesh.dp=-1", "mesh.dcn=2", "batch_size=8"],
]


@pytest.mark.parametrize("overrides", OVERRIDE_SETS,
                         ids=[",".join(o) or "default" for o in OVERRIDE_SETS])
def test_compose_matches_jax(overrides, monkeypatch):
    monkeypatch.setenv("BIFOLD_TEST_CONFIG_SET", "set-value")
    monkeypatch.delenv("BIFOLD_TEST_CONFIG_ROOT", raising=False)
    got = config.compose(overrides)
    want = jax_config.compose(overrides)
    assert got.to_dict() == want.to_dict()
    assert config.to_yaml(got) == jax_config.to_yaml(want)
    assert override_dirname(overrides) == jax_override_dirname(overrides)


@pytest.mark.parametrize("overrides, error", [
    (["model=no_such_model"], "MissingConfigError"),
    (["+a=${b}", "+b=${a}"], "InterpolationError"),
    (["+a=${no.such.key}"], "InterpolationError"),
    (["+a=${oc.env:BIFOLD_TEST_CONFIG_UNSET}"], "InterpolationError"),
    (["batch_size"], "ValueError"),
])
def test_compose_errors_match_jax(overrides, error, monkeypatch):
    monkeypatch.delenv("BIFOLD_TEST_CONFIG_UNSET", raising=False)
    with pytest.raises(getattr(jax_config, error, ValueError)):
        jax_config.compose(overrides)
    with pytest.raises(getattr(config, error, ValueError)):
        config.compose(overrides)


def test_conf_files_hold_the_jax_values():
    jax_files = sorted(p.relative_to(ROOT / "bifold_tpu/conf")
                       for p in (ROOT / "bifold_tpu/conf").rglob("*.yaml"))
    port_files = sorted(p.relative_to(ROOT / "bifold_tpu_torch/conf")
                        for p in (ROOT / "bifold_tpu_torch/conf").rglob("*.yaml"))
    assert port_files == jax_files
    for rel in jax_files:
        assert (config.load_yaml(ROOT / "bifold_tpu_torch/conf" / rel)
                == jax_config.load_yaml(ROOT / "bifold_tpu/conf" / rel)), rel


def test_save_and_config_access(tmp_path):
    cfg = config.compose(["model=siglip", "+n.m=2"])
    config.save(cfg, tmp_path / "config.yaml")
    assert config.load_yaml(tmp_path / "config.yaml") == cfg.to_dict()
    assert (tmp_path / "config.yaml").read_text() == jax_config.to_yaml(
        jax_config.compose(["model=siglip", "+n.m=2"]))
    assert cfg.model.name == "siglip" and cfg.select("n.m") == 2
    assert cfg.select("no.such", 5) == 5
    assert config.merge({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) == {"a": {"b": 3, "c": 2}}
