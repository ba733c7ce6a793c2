"""Rank bodies of the multi-rank tests, importing torch and the port only
(no JAX): ``run`` is one process of ``tests/test_torch_parallel.py``'s gloo
group on the CPU, ``cuda_rank`` one of ``tests/test_torch_cuda_parallel.py``'s
two ranks on cuda:0.  Each rank writes what it computed to
``<out_dir>/rank<r>.pkl`` for the test to compare.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from tstar_tpu_torch.video.synthetic import PlantedObject, SyntheticDecoder

TARGETS, CUES = ["couch", "lamp"], ["tv"]
SEEDS = (3, 11, 20, 27)
CONFIG = dict(search_budget=0.5, cache_hw=(32, 64), deterministic_pop=True)

# __graft_entry__.py's tiny Qwen2-VL (dryrun_multichip)
QWEN_VISION = dict(depth=2, embed_dim=16, num_heads=2, mlp_ratio=2.0, patch_size=2,
                   temporal_patch_size=1, spatial_merge_size=2, hidden_size=32)
QWEN_TEXT = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=4, num_kv_heads=2,
                 intermediate_size=64, mrope_section=(1, 1, 2))
VLM_IDS = np.array([[5, 251, 251, 251, 251, 9]])   # one 4x4-grid image + text
NEW_TOKENS = 6


def tiny_owlvit(module):
    """``__graft_entry__.py``'s tiny OWL-ViT in either package."""
    v = module.VisionConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                            patch_size=16, image_size=64)
    t = module.TextConfig(vocab_size=100, hidden_size=24, num_layers=2, num_heads=4,
                          intermediate_size=48, max_length=8)
    return module.OwlViTConfig(vision=v, text=t, projection_dim=24)


def decoders():
    """Four 300 s scenes (one length bucket), the objects moved apart."""
    def scene(shift):
        return SyntheticDecoder(300.0, objects=[
            PlantedObject("couch", (70.0 + shift, 80.0 + shift), (200, 40, 40), (0.55, 0.4), 0.45),
            PlantedObject("lamp", (250.0 - shift, 262.0 - shift), (230, 220, 60), (0.4, 0.6), 0.3),
            PlantedObject("tv", (30.0 + shift, 90.0 + shift), (40, 40, 200), (0.3, 0.75), 0.25),
        ])
    return [scene(s) for s in (0.0, 40.0, 90.0, 150.0)]


def run(rank: int, world: int, port: int, spec: dict, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = _body(spec)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@torch.no_grad()
def _body(spec: dict) -> dict:
    from tstar_tpu_torch.framework.heuristics import initialize_heuristic
    from tstar_tpu_torch.models import owlvit as tow
    from tstar_tpu_torch.models import qwen2vl as tqwen
    from tstar_tpu_torch.models.generate import generate
    from tstar_tpu_torch.models.tensor_parallel import TensorParallel, agree
    from tstar_tpu_torch.parallel import make_mesh, replicated, shard_module
    from tstar_tpu_torch.parallel import multi_video as mv
    from tstar_tpu_torch.search.step_graphs import StepStats
    from tstar_tpu_torch.utils.config import SearchConfig

    out = {}
    try:
        make_mesh(data=3, model=2, device="cpu")
    except ValueError as e:
        out["bad_shape_error"] = str(e)
    mesh = make_mesh(data=2, model=2, device="cpu")
    out["coords"] = (mesh.data_index, mesh.model_index)
    out["device_mesh"] = mesh.device_mesh.mesh.tolist()
    out["coordinate"] = tuple(mesh.device_mesh.get_coordinate())
    out["replicated"] = replicated(mesh, torch.full((3,), float(dist.get_rank()))).tolist()
    agree([7, 8], TensorParallel(mesh), "a shared value", "cpu")
    try:        # ranks whose next collectives would differ raise, not hang
        agree([dist.get_rank()], TensorParallel(mesh), "a loop flag", "cpu")
    except RuntimeError as e:
        out["disagree_error"] = str(e)

    # the dp x tp search, each video on the reference's replayed noise
    heur = initialize_heuristic("owl-vit-random", device="cpu", dtype=torch.float32,
                                model_config=tiny_owlvit(tow))
    heur.model.load_state_dict(spec["owl_state"], strict=True)
    full = tow.OwlViTDetector(tiny_owlvit(tow)).requires_grad_(False).eval()
    full.load_state_dict(spec["owl_state"], strict=True)
    shard_module(heur.model, mesh)
    real_init = mv.init_state

    def replayed(n_valid, n_targets, config, rng, n_pad=None, device=None):
        return real_init(n_valid, n_targets, config, iter(spec["noise"][rng.initial_seed()]),
                         n_pad=n_pad, device=device)

    mv.init_state = replayed
    try:
        tasks = [mv.VideoTask(f"mem://{i}", TARGETS, CUES, seed=s, decoder=d)
                 for i, (s, d) in enumerate(zip(SEEDS, decoders()))]
        stats = StepStats()
        out["rows"] = mv.search_videos(tasks, heur, SearchConfig(**CONFIG), mesh=mesh,
                                       stats=stats)
        out["steps"] = stats.steps
    finally:
        mv.init_state = real_init

    # the TP grid forward against the whole model on this rank
    px = torch.from_numpy(spec["pixels"])
    q = full.encode_text(*(torch.from_numpy(a) for a in spec["text"]))
    feats, feats_tp = full.encode_image(px), heur.model.encode_image(px)
    logits, boxes = full.predict(feats, q)
    logits_tp, boxes_tp = heur.model.predict(feats_tp, heur.model.encode_text(
        *(torch.from_numpy(a) for a in spec["text"])))
    out["forward_err"] = max((a - b).abs().max().item() for a, b in (
        (feats, feats_tp), (logits, logits_tp), (boxes, boxes_tp)))

    # the TP Qwen2-VL: greedy tokens, and a sampled decode
    cfg = tqwen.Qwen2VLConfig(vision=tqwen.Qwen2VLVisionConfig(**QWEN_VISION),
                              text=tqwen.Qwen2VLTextConfig(**QWEN_TEXT), image_token_id=251)
    vlm = tqwen.Qwen2VLModel(cfg).requires_grad_(False).eval()
    vlm.load_state_dict(spec["qwen_state"], strict=True)
    shard_module(vlm, mesh)
    pos = tqwen.build_mrope_position_ids(VLM_IDS[0], 251, [(1, 4, 4)], 2)[:, None]
    kw = dict(max_new_tokens=NEW_TOKENS, eos_token_ids=[255],
              image_patches=torch.from_numpy(spec["patches"]), image_grid_hw=(4, 4))
    out["greedy"] = generate(vlm, VLM_IDS, np.array([6]), pos, **kw).tolist()
    for name, seed in (("sampled_same_seed", 7), ("sampled_rank_seed", 100 + dist.get_rank())):
        g = torch.Generator().manual_seed(seed)
        out[name] = generate(vlm, VLM_IDS, np.array([6]), pos, temperature=0.7, generator=g,
                             **kw).tolist()
    return out


# ---------------------------------------------------------------------------
# rank bodies of the card tests (tests/test_torch_cuda_parallel.py)
# ---------------------------------------------------------------------------

def cuda_rank(rank: int, world: int, port: int, body: str, out_dir: str) -> None:
    """One rank on cuda:0 in a gloo group, running ``body``."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        out = globals()[body]()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@torch.no_grad()
def tp_b32_forward() -> dict:
    """B/32 at full width and two layers, sharded over two ranks on one
    card: its grid scores against the whole model's, and K1's launches."""
    import dataclasses

    from tstar_tpu_torch.kernels import attention
    from tstar_tpu_torch.models import owlvit as tow
    from tstar_tpu_torch.parallel import make_mesh, shard_module

    mesh = make_mesh(data=1, model=2, backend="gloo", device="cuda:0")
    base = tow.owlvit_base_patch32()
    cfg = dataclasses.replace(base, vision=dataclasses.replace(base.vision, num_layers=2),
                              text=dataclasses.replace(base.text, num_layers=2))
    whole = tow.init_params(tow.OwlViTDetector(cfg), 0).to("cuda:0", torch.bfloat16)
    sharded = shard_module(tow.init_params(tow.OwlViTDetector(cfg), 0).to("cuda:0", torch.bfloat16),
                           mesh)
    g = torch.Generator(device="cuda:0").manual_seed(1)
    px = torch.randn(2, 768, 768, 3, generator=g, device="cuda:0").to(torch.bfloat16)
    q = torch.nn.functional.normalize(torch.randn(3, 512, generator=g, device="cuda:0"), dim=-1)
    want = tow.postprocess_detections(*whole.predict(whole.encode_image(px), q.bfloat16()),
                                      (768, 768))
    attention.fused_mha_from_qkv.launches = 0
    got = tow.postprocess_detections(*sharded.predict(sharded.encode_image(px), q.bfloat16()),
                                     (768, 768))
    torch.cuda.synchronize()
    return {"score_err": (got[0].float() - want[0].float()).abs().max().item(),
            "k1": attention.fused_mha_from_qkv.launches,
            "heads": sharded.vision.encoder.layers[0].self_attn.num_heads}


def nccl_on_one_card() -> dict:
    """Ask for NCCL with both ranks on cuda:0: make_mesh must refuse."""
    from tstar_tpu_torch.parallel import make_mesh

    try:
        make_mesh(data=1, model=2, backend="nccl", device="cuda:0")
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}
