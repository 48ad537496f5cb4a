"""Graph conditioning in the port against the JAX package, on the CPU.

A graph-conditioned config (``requires_graph: true``) makes the Processor
build a point-cloud graph of each sample on the host: the depth map
back-projected through the camera, voxelized, farthest-point sampled and
joined by radius edges. Voxels and FPS are discontinuous in their inputs,
so each stage is held against JAX's on JAX's own inputs, exactly:

- ``voxelize_pointcloud``, ``fps`` and ``compute_edge_attr`` on JAX's
  point cloud, and the three geometry functions (the extrinsic's inverse
  included) on the unimanual camera and perturbed ones: bitwise;
- ``Processor._graph_features`` end to end on numpy-seeded 128 px inputs
  (64 px model, 50 nodes): ``graph_x``, the edge attributes and the nodes'
  pixels within 1e-5, the edge index, masks and node heatmaps equal; and a
  whole ``Processor.__call__`` sample (images within 1e-5);
- ``decode_action``'s graph branch on the inputs of
  ``tests/test_model_variants.py::test_decode_action_graph_mode``;
- the two-dispatch server against JAX's ``ServingModel`` with a graph
  Processor (JAX's ``predict`` passes no camera, so the test's JAX
  Processor adds it): actions equal, heatmaps within 1e-4; the graph
  server's actions equal to the one-dispatch server's on the same weights;
  ``pad_to`` adds no rows, ``program_memory`` is None, ``export`` and
  ``from_checkpoint`` without a Processor refuse;
- a synthetic graph dataset's records and a loader batch against JAX's;
  an empty cloth mask raises in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bifold_tpu.data import utils as jax_utils
from bifold_tpu.data.datasets import SyntheticDataset as JaxSynthetic
from bifold_tpu.data.datasets import deng_camera_matrices
from bifold_tpu.data.processor import Processor as JaxProcessor
from bifold_tpu.data.spm import fixture_model_bytes
from bifold_tpu.models import build_model as jax_build_model
from bifold_tpu.models import decode_action as jax_decode_action
from bifold_tpu.ops import geometry as jax_geometry
from bifold_tpu.serving import ServingModel as JaxServingModel
from bifold_tpu_torch.data import utils as port_utils
from bifold_tpu_torch.data.datasets import SyntheticDataset
from bifold_tpu_torch.data.loader import DataLoader
from bifold_tpu_torch.data.processor import Processor
from bifold_tpu_torch.models import build_model, decode_action
from bifold_tpu_torch.models.convert import convert_bifold_inverse
from bifold_tpu_torch.ops import geometry as port_geometry
from bifold_tpu_torch.ops.geometry import intrinsic_from_fov
from bifold_tpu_torch.serving import ServingModel

F32_TOL = 1e-4
GRAPH_TOL = 1e-5
SIZE = 128
GRAPH = dict(num_nodes=50, neighbor_radius=0.1, voxel_size=0.02)
PROC_CFG = {"model_image_size": 64, "text_encoder": None, "sigma": 5,
            "requires_graph": True, "spatial_augment": False, "strategy": "gmm",
            "mask_depth": True, "standardize_depth": False}
CFG = {"name": "siglip_sequential", "image_size": 64, "is_bimanual": True,
       "patch_size": 16, "automodel_name": "tiny", "dim": 64, "lora": True, "r": 8,
       "lora_alpha": 32, "lora_dropout": 0.0, "depth": 1, "heads": 4,
       "context_length": 2, "threshold": 0.01, "requires_graph": True}
FIELDS = ("left_pick", "right_pick", "left_place", "right_place")
M_W2C = deng_camera_matrices()[0].astype(np.float32)
K = intrinsic_from_fov(SIZE, SIZE, fov=45).astype(np.float32)
# the graph features held within GRAPH_TOL; the others (edge index, masks,
# node heatmaps) equal
CLOSE = ("graph_x", "graph_edge_attr", "pixel_sampled_pc")


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _frame(rng, size=SIZE):
    return dict(rgb=rng.integers(0, 255, (size, size, 3), dtype=np.uint8),
                depth=(0.97 + 0.02 * rng.random((size, size))).astype(np.float32),
                mask=(rng.random((size, size)) > 0.3).astype(np.float32))


def _cameras():
    rng = np.random.default_rng(4)
    return [M_W2C] + [(M_W2C + 0.05 * rng.standard_normal((4, 4))).astype(np.float32)
                      for _ in range(2)]


@pytest.mark.parametrize("camera", range(3))
def test_graph_helpers_match_jax_exactly(camera):
    """Each stage on JAX's own inputs: the geometry (float32, the
    extrinsic's inverse too), then the voxels, FPS and radius edges of
    JAX's point cloud."""
    m = _cameras()[camera]
    rng = np.random.default_rng(camera)
    depth = _frame(rng, 64)["depth"]
    k = K.copy()
    k[:2] /= SIZE / 64
    world = np.asarray(jax_geometry.world_coords_from_depth(depth, m, k))
    np.testing.assert_array_equal(port_geometry.world_coords_from_depth(depth, m, k).numpy(),
                                  world)
    pix = rng.uniform(0, 63, 2).astype(np.float32)
    np.testing.assert_array_equal(port_geometry.world_from_pixel(pix, depth, m, k).numpy(),
                                  np.asarray(jax_geometry.world_from_pixel(pix, depth, m, k)))
    pc = world[..., :3].reshape(-1, 3)[rng.random(64 * 64) > 0.4].astype(np.float32)
    np.testing.assert_array_equal(port_geometry.pixel_from_world(pc[:40], m, k).numpy(),
                                  np.asarray(jax_geometry.pixel_from_world(pc[:40], m, k)))
    vox = jax_utils.voxelize_pointcloud(pc, 0.02)
    np.testing.assert_array_equal(port_utils.voxelize_pointcloud(pc, 0.02), vox)
    sampled = jax_utils.fps(vox, 50)
    np.testing.assert_array_equal(port_utils.fps(vox, 50), sampled)
    for got, want in zip(port_utils.compute_edge_attr(sampled, 0.1),
                         jax_utils.compute_edge_attr(sampled, 0.1)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert port_utils.compute_edge_attr(sampled, 0.1)[0].shape[1] > 0


def _check_graph(got, want):
    graph = [k for k in want if k.startswith("graph") or k.endswith("_node_heatmap")
             or k == "pixel_sampled_pc"]
    assert sorted(k for k in got if k in graph or k.startswith("graph")) == sorted(graph)
    for k in graph:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if k in CLOSE:
            np.testing.assert_allclose(a, b, atol=GRAPH_TOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
    return graph


@pytest.mark.parametrize("partition", ["test", "train"])
def test_graph_features_match_jax(partition):
    jproc = JaxProcessor(PROC_CFG, partition=partition, **GRAPH)
    tproc = Processor(PROC_CFG, partition=partition, **GRAPH)
    edges = 0
    for seed in range(3):
        obs = _frame(np.random.default_rng(seed))
        raw = jproc.make_raw(**obs, instruction="fold", matrix_world_to_camera=M_W2C, K=K,
                             left_pick=np.array([40.0, 50.0]), right_pick=None,
                             left_place=np.array([60.0, 60.0]), right_place=None)
        got = tproc._graph_features(raw)
        graph = _check_graph(got, jproc._graph_features(raw))
        assert ("pixel_sampled_pc" in graph) == (partition == "test")
        assert {"left_pick_node_heatmap", "right_pick_node_heatmap"} <= set(graph)
        edges += int(got["graph_edge_mask"].sum())
    assert edges > 0
    # one whole sample through __call__ (host processing, numpy out)
    kw = dict(instruction="fold", matrix_world_to_camera=M_W2C, K=K,
              pick=np.array([40.0, 50.0]), place=np.array([60.0, 60.0]))
    obs = _frame(np.random.default_rng(7))
    want, got = jproc(**obs, **kw), tproc(**obs, **kw)
    graph = _check_graph(got, want)
    for k in ("rgb", "depth", "mask", "pick", "place"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), atol=GRAPH_TOL, err_msg=k)
    assert set(got) == {k for k in want if k != "raw_instruction"} | {"raw_instruction"}
    assert "pick_node_heatmap" in graph and got["pick_node_heatmap"].sum() >= 1


def test_graph_needs_its_sizes_and_the_camera():
    with pytest.raises(ValueError, match="num_nodes"):
        Processor(PROC_CFG)
    proc = Processor(PROC_CFG, **GRAPH)
    with pytest.raises(ValueError, match="camera"):
        proc(**_frame(np.random.default_rng(0)), instruction="fold")


def test_decode_action_graph_mode():
    """The inputs of tests/test_model_variants.py's graph-mode decode."""
    rng = np.random.default_rng(0)
    b, n = 2, 10
    probs = rng.random((b, n)).astype(np.float32)
    pc = rng.uniform(0, 64, (b, n, 2)).astype(np.float32)
    place = np.zeros((b, 16, 16), np.float32)
    place[:, 5, 7] = 1.0
    for bimanual in (False, True):
        heads = FIELDS if bimanual else ("pick", "place")
        out = {f"{h}_heatmap": probs if "pick" in h else place for h in heads}
        kw = dict(is_bimanual=bimanual, constrain_pick_mask=False, threshold=0.5)
        want = jax_decode_action({k: jnp.asarray(v) for k, v in out.items()},
                                 {"pixel_sampled_pc": jnp.asarray(pc)}, **kw)
        got = decode_action({k: torch.from_numpy(v) for k, v in out.items()},
                            {"pixel_sampled_pc": torch.from_numpy(pc)}, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    for i in range(b):
        np.testing.assert_array_equal(got["left_pick"].numpy()[i], pc[i, probs[i].argmax()])


class _JaxCamera(JaxProcessor):
    """JAX's Processor with the camera added to every call: JAX's
    ``predict`` has no camera argument, and its graph path needs one."""

    def __call__(self, **kw):
        return super().__call__(**kw, matrix_world_to_camera=M_W2C, K=K)


@pytest.fixture(scope="module")
def servers():
    spm = fixture_model_bytes()
    model = jax_build_model(CFG)
    init = {"rgb": np.zeros((1, 3, 64, 64), np.float32),
            "instruction": np.zeros((1, 64), np.int32),
            "rgb_context": np.zeros((1, 2, 3, 64, 64), np.float32),
            "context_attention_mask": np.ones((1, 2), np.int32)}
    params = jax.tree_util.tree_map(np.asarray, jax.jit(lambda k: model.init(
        k, {n: jnp.asarray(v) for n, v in init.items()}, deterministic=True))(
            jax.random.key(0))["params"])
    state = convert_bifold_inverse(params)
    kw = dict(max_context_length=2, autoprocessor_name="tiny", spm_asset=spm)
    jserver = JaxServingModel(model, {"params": params},
                              _JaxCamera(PROC_CFG, partition="test", **GRAPH, **kw),
                              threshold=0.01)
    port = build_model(CFG, device="cpu")
    tserver = ServingModel(port, state, Processor(PROC_CFG, **GRAPH, **kw), device="cpu")
    plain = ServingModel(port, state, Processor(dict(PROC_CFG, requires_graph=False), **kw),
                         device="cpu")
    return jserver, tserver, plain


def _observations(n, seed):
    rng = np.random.default_rng(seed)
    return [dict(_frame(rng), instruction=f"fold the towel {i}",
                 context=[_frame(rng) for _ in range(i % 3)]) for i in range(n)]


def test_two_dispatch_server_matches_jax(servers):
    jserver, tserver, plain = servers
    camera = dict(matrix_world_to_camera=M_W2C, K=K)
    obs = _observations(3, 1)
    ja = jserver.predict_batch(obs, pad_to=4)
    # JAX's graph predict_batch cannot return raw outputs (it concatenates
    # the heads' None attention weights), so its raws come one at a time
    raws = [jserver.predict(**o, return_raw_output=True)[1] for o in obs]
    jr = {k: np.concatenate([np.asarray(r[k]) for r in raws])
          for k in raws[0] if raws[0][k] is not None}
    (ta, tr) = tserver.predict_batch([dict(o, **camera) for o in obs], pad_to=4,
                                     return_raw_output=True)
    assert sorted(tr) == sorted(jr)
    for k in tr:
        assert tr[k].shape[0] == 3, k                  # pad_to adds no rows
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), atol=F32_TOL, err_msg=k)
    pa = plain.predict_batch(obs, pad_to=4)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ja, f)), err_msg=f)
        np.testing.assert_array_equal(getattr(ta, f), getattr(pa, f), err_msg=f)
    one = tserver.predict(**obs[0], **camera)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(one, f), getattr(ta, f)[:1], err_msg=f)
    assert tserver.program_memory(**obs[0]) is None
    with pytest.raises(NotImplementedError, match="graph"):
        tserver.export("unused.pt", **obs[0])
    with pytest.raises(ValueError, match="processor="):
        ServingModel.from_checkpoint("unused.ckpt", {"model": CFG, "processor": PROC_CFG},
                                     device="cpu")


class _Subset:
    """The records ``index`` of ``dataset``, for the loader."""

    def __init__(self, dataset, index):
        self.dataset, self.index, self.processor = dataset, index, dataset.processor

    def __len__(self):
        return len(self.index)

    def __getitem__(self, i):
        return self.dataset[self.index[i]]


def test_graph_dataset_and_loader_match_jax():
    """The synthetic scenes' cloth masks are often empty: both packages'
    graph features raise a ValueError on those; the others' records and a
    loader batch of them equal JAX's."""
    cfg = {"name": "synthetic", "n_samples": 6, "image_size": 64, "is_bimanual": True,
           "max_context_length": 0, "num_nodes": 30, "neighbor_radius": 0.045,
           "voxel_size": 0.0125, "seed": 3}
    proc = dict(PROC_CFG, spatial_augment=True)
    jds, tds = (cls(cfg, proc, partition="train") for cls in (JaxSynthetic, SyntheticDataset))
    plain = SyntheticDataset(cfg, dict(proc, requires_graph=False), partition="train")
    cloth = [i for i in range(len(tds)) if plain[i]["mask"].any()]
    assert 0 < len(cloth) < len(tds)
    for i in set(range(len(tds))) - set(cloth):
        for ds in (jds, tds):
            with pytest.raises(ValueError):
                ds[i]
    records = [tds[i] for i in cloth]
    for i, rec in zip(cloth, records):
        _check_graph(rec, jds[i])
    got = next(iter(DataLoader(_Subset(tds, cloth), batch_size=len(cloth), shuffle=False,
                               device="cpu")))
    for k in ("graph_x", "graph_node_mask", "graph_edge_index", "graph_edge_attr",
              "graph_edge_mask", "left_pick_node_heatmap", "right_pick_node_heatmap"):
        np.testing.assert_array_equal(got[k].numpy(), np.stack([r[k] for r in records]),
                                      err_msg=k)
