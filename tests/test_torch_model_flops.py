"""``chip_smoke.model_flops``, the count behind the model-FLOPs share that
the card's training phases print, against counts made by hand from the
configs' widths: the encoder (no input embedding, every (query, key) pair
kept) and the VLM (its cross layers' keys and values projected from the
image, and its S x image pairs)."""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.configs.base import get_config
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

B, S = 2, 24


def _params(cfg):
    return dict(lm.init(0, cfg, device="cpu").named_parameters())


def test_encoder_counts_every_pair_and_no_embedding():
    cfg = get_config("hubert-xlarge").smoke()
    d, ff, hd, H, KV, L = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    layer = d * hd * (2 * H + 2 * KV) + 2 * d * ff + 2 * d  # q, k, v, o; w1, w2; two norms
    params = L * layer + d + d * cfg.vocab  # the final norm and the head
    want = 6.0 * params * B * S + 12.0 * B * H * hd * L * S * S
    flops, active = chip_smoke.model_flops(cfg, _params(cfg), B, S)
    assert active == params
    assert flops == pytest.approx(want, rel=1e-12)


def test_vlm_projects_the_image_in_its_cross_layers():
    cfg = get_config("llama-3.2-vision-11b").smoke()
    d, ff, hd, H, KV, L = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.n_layers
    T, every = cfg.img_tokens, cfg.cross_attn_every
    n_cross = L // every
    n_self = L - n_cross
    attn = d * hd * (2 * H + 2 * KV) + d  # q, k, v, o and the norm
    mlp = 3 * d * ff + d  # SwiGLU and its norm
    cross_extra = 1 + d  # the gate and the image's norm
    params = n_self * (attn + mlp) + n_cross * (attn + mlp + cross_extra) + d + d * cfg.vocab
    image_kv = n_cross * 2 * d * KV * hd  # wk and wv read the T image tokens
    pairs = n_self * S * (S + 1) // 2 + n_cross * S * T
    want = 6.0 * B * ((params - image_kv) * S + image_kv * T) + 12.0 * B * H * hd * pairs
    flops, active = chip_smoke.model_flops(cfg, _params(cfg), B, S)
    assert active == params  # the embedding is a lookup: not counted
    assert flops == pytest.approx(want, rel=1e-12)


def test_dense_count_is_unchanged_by_the_new_families():
    """A dense causal model: 6 per parameter a token and its causal pairs, as
    before the encoder and the VLM were counted."""
    cfg = get_config("granite-8b").smoke()
    params = _params(cfg)
    total = sum(p.numel() for p in params.values())
    active = total - (0 if cfg.tie_embeddings else params["embed"].numel())
    want = 6.0 * active * B * S + 12.0 * cfg.n_layers * B * cfg.n_heads * cfg.hd * S * (S + 1) // 2
    assert chip_smoke.model_flops(cfg, params, B, S) == (pytest.approx(want, rel=1e-12), active)
