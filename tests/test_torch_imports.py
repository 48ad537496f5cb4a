"""Import hygiene of the PyTorch port: no module of ``bifold_tpu_torch`` and
not ``chip_smoke.py`` may import JAX, flax or the JAX package; the closed
loop's modules (``env/`` and ``utils/visualization.py``) name none of cv2,
Pillow, matplotlib or imageio, which the card's host lacks; pandas is named
only by the vr-folding data modules (the dataset and its offline tools)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "bifold_tpu", "safetensors",
           "transformers")
IMAGING = ("cv2", "PIL", "matplotlib", "imageio")
PANDAS_MODULES = ("data/bimanual_dataset.py", "data/vr_folding.py",
                  "data/create_dataset_partitions.py")

_CHILD = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None          # any import of these now raises
import bifold_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bifold_tpu_torch.__path__,
                                               "bifold_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("bifold_tpu_torch.ops._cuda", "bifold_tpu_torch.ops.layer_norm",
             "bifold_tpu_torch.serve", "bifold_tpu_torch.config",
             "bifold_tpu_torch.utils.checkpoint", "bifold_tpu_torch.trainer",
             "bifold_tpu_torch.__main__", "bifold_tpu_torch.data.loader",
             "bifold_tpu_torch.metrics", "bifold_tpu_torch.models.norm",
             "bifold_tpu_torch.models.backbones.clip_backbone",
             "bifold_tpu_torch.models.backbones.t5_backbone",
             "bifold_tpu_torch.utils.safetensors", "bifold_tpu_torch.parallel.collectives",
             "bifold_tpu_torch.parallel.sharding", "bifold_tpu_torch.parallel.pipeline",
             "bifold_tpu_torch.parallel.advisor", "bifold_tpu_torch.ops.ring_attention",
             "bifold_tpu_torch.env.native", "bifold_tpu_torch.env.sim",
             "bifold_tpu_torch.env.garments", "bifold_tpu_torch.env.cloth_env",
             "bifold_tpu_torch.env.demonstrators", "bifold_tpu_torch.env.cache_builder",
             "bifold_tpu_torch.env.softgym_evaluator",
             "bifold_tpu_torch.env.bimanual_evaluator",
             "bifold_tpu_torch.utils.visualization", "bifold_tpu_torch.version",
             "bifold_tpu_torch.data.vr_folding",
             "bifold_tpu_torch.data.create_dataset_partitions",
             "bifold_tpu_torch.env.scenes", "bifold_tpu_torch.env.pyflex_compat",
             "bifold_tpu_torch.env.xml_model"):
    assert name in names, name
from bifold_tpu_torch.data.tokenizers import clip_bpe_path
assert clip_bpe_path().parent.parent.parent.name == "bifold_tpu_torch", clip_bpe_path()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in {BLOCKED!r} and sys.modules[m] is not None)
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "BIFOLD_CLIP_BPE"}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 50   # every module was imported


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_sources_name_no_jax_import():
    files = [ROOT / "chip_smoke.py", *sorted((ROOT / "bifold_tpu_torch").rglob("*.py"))]
    assert files[0].exists()
    for path in files:
        bad = set(_imported_roots(path)) & set(BLOCKED)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def _named_modules(path: Path):
    """Every module an import statement, ``__import__`` or
    ``importlib.import_module`` names in ``path`` (at top level or inside a
    function)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = getattr(fn, "id", None) or getattr(fn, "attr", None)
            if name in ("__import__", "import_module") and node.args \
                    and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


_CLOSED_LOOP_CHILD = f"""
import importlib, sys
for name in {BLOCKED + IMAGING!r}:
    sys.modules[name] = None
for name in ("bifold_tpu_torch.trainer", "bifold_tpu_torch.__main__",
             "bifold_tpu_torch.serving", "bifold_tpu_torch.serve",
             "bifold_tpu_torch.env.cache_builder",
             "bifold_tpu_torch.env.softgym_evaluator",
             "bifold_tpu_torch.env.bimanual_evaluator",
             "bifold_tpu_torch.utils.visualization", "bifold_tpu_torch.version",
             "bifold_tpu_torch.data.vr_folding",
             "bifold_tpu_torch.data.create_dataset_partitions",
             "bifold_tpu_torch.env.scenes", "bifold_tpu_torch.env.pyflex_compat",
             "bifold_tpu_torch.env.xml_model"):
    importlib.import_module(name)
"""


def test_closed_loop_imports_without_imaging_library():
    """The Trainer, the serving modules and the closed loop's modules import
    with cv2, Pillow, matplotlib and imageio (and JAX) absent."""
    proc = subprocess.run([sys.executable, "-c", _CLOSED_LOOP_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_closed_loop_names_no_imaging_library():
    files = [*sorted((ROOT / "bifold_tpu_torch" / "env").glob("*.py")),
             ROOT / "bifold_tpu_torch" / "utils" / "visualization.py"]
    assert len(files) >= 13
    assert {"scenes.py", "pyflex_compat.py", "xml_model.py"} <= {p.name for p in files}
    for path in files:
        bad = {m.split(".")[0] for m in _named_modules(path)} & set(IMAGING)
        assert not bad, f"{path.relative_to(ROOT)} names {sorted(bad)}"


def test_pandas_only_in_the_vr_folding_data_modules():
    """pandas (absent on the card's host) is named by the vr-folding dataset
    and its offline tools only; the registry reaches the dataset through a
    factory, so every other module imports without it."""
    named = sorted(str(path.relative_to(ROOT / "bifold_tpu_torch"))
                   for path in (ROOT / "bifold_tpu_torch").rglob("*.py")
                   if "pandas" in {m.split(".")[0] for m in _named_modules(path)})
    assert named == sorted(PANDAS_MODULES)
    assert "pandas" not in {m.split(".")[0] for m in _named_modules(ROOT / "chip_smoke.py")}


def test_clip_bpe_asset_is_the_ports_own(monkeypatch):
    """The port reads its own copy of the CLIP merges file (package data),
    byte-equal to the JAX package's, never the JAX package's file."""
    from bifold_tpu_torch.data.tokenizers import clip_bpe_path

    monkeypatch.delenv("BIFOLD_CLIP_BPE", raising=False)
    path = clip_bpe_path()
    assert path == ROOT / "bifold_tpu_torch/data/assets/bpe_simple_vocab_16e6.txt.gz"
    assert path.read_bytes() == (ROOT / "bifold_tpu/data/assets"
                                 / path.name).read_bytes()
    assert '"data/assets/*.gz"]' in (ROOT / "pyproject.toml").read_text().split(
        "bifold_tpu_torch = ")[1].splitlines()[0]
    monkeypatch.setenv("BIFOLD_CLIP_BPE", str(path))
    assert clip_bpe_path() == path
