"""Upstream checkpoint names and layouts for the port.

The transforms ``t_*`` and the per-tower mapping tables (``full_mapping``)
say, for every tensor of the upstream ``lvdm`` state dict, its key, its
path in a JAX parameter tree and the layout change between the two
(Linear (O,I) <-> (I,O), Conv2d OIHW <-> HWIO, Conv3d OITHW <-> THWIO).
The port's modules carry the upstream keys, so a checkpoint loads with
``load_state_dict``; the tables serve ``utils/weights.from_jax_params`` and
list every tensor the model has. Numpy only, apart from ``torch.load``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def t_linear(w):
    return np.ascontiguousarray(np.transpose(w))


def t_conv2d(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def t_conv1x1(w):
    return np.ascontiguousarray(np.transpose(w[:, :, 0, 0]))


def t_conv1d1(w):
    """Conv1d kernel-size-1 (O,I,1) -> Dense (I,O)."""
    return np.ascontiguousarray(np.transpose(w[:, :, 0]))


def t_conv3d(w):
    return np.ascontiguousarray(np.transpose(w, (2, 3, 4, 1, 0)))


def t_none(w):
    # note: np.ascontiguousarray promotes 0-dim scalars (e.g. the learnable
    # image-cross-attention `alpha`, attention.py:78) to shape (1,) — reshape
    # back to preserve the torch shape exactly
    return np.ascontiguousarray(w).reshape(np.shape(w))


# ---------------------------------------------------------------------------
# dialect normalization
# ---------------------------------------------------------------------------

def load_torch_state_dict(path: str, allow_pickle: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """Load an upstream checkpoint as fp32 CPU tensors under the upstream
    keys, from any of its three dialects: Lightning ``{'state_dict': ...}``,
    DeepSpeed ``{'module': ...}`` (16-character ``_forward_module.``
    prefix), and the legacy ``framestride_embed`` name of
    ``fps_embedding``.

    weights_only=True by default: a .ckpt is supplied from outside and full
    unpickling runs arbitrary code. Pass allow_pickle=True only for trusted
    legacy checkpoints that predate the weights-only format.
    """
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not allow_pickle:
            raise
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    elif "module" in sd:
        sd = {k[16:]: v for k, v in sd["module"].items()}
    out = {}
    for k, v in sd.items():
        k = k.replace("framestride_embed", "fps_embedding")
        out[k] = torch.as_tensor(v).float()
    return out


# ---------------------------------------------------------------------------
# mapping generation
# ---------------------------------------------------------------------------

Entry = Tuple[Tuple[str, ...], str, Callable]  # (jax path, torch key, fn)


def _norm(entries, jp, tp):
    entries.append((jp + ("weight",), tp + ".weight", t_none))
    entries.append((jp + ("bias",), tp + ".bias", t_none))


def _dense(entries, jp, tp, bias=True):
    entries.append((jp + ("kernel",), tp + ".weight", t_linear))
    if bias:
        entries.append((jp + ("bias",), tp + ".bias", t_none))


def _conv(entries, jp, tp, nd=2, bias=True):
    fn = t_conv2d if nd == 2 else t_conv3d
    entries.append((jp + ("kernel",), tp + ".weight", fn))
    if bias:
        entries.append((jp + ("bias",), tp + ".bias", t_none))


def _dense_from_1x1(entries, jp, tp, bias=True):
    entries.append((jp + ("kernel",), tp + ".weight", t_conv1x1))
    if bias:
        entries.append((jp + ("bias",), tp + ".bias", t_none))


def _cross_attention(entries, jp, tp, image_branch=False):
    _dense(entries, jp + ("to_q",), tp + ".to_q", bias=False)
    _dense(entries, jp + ("to_k",), tp + ".to_k", bias=False)
    _dense(entries, jp + ("to_v",), tp + ".to_v", bias=False)
    _dense(entries, jp + ("to_out",), tp + ".to_out.0")
    if image_branch:
        _dense(entries, jp + ("to_k_ip",), tp + ".to_k_ip", bias=False)
        _dense(entries, jp + ("to_v_ip",), tp + ".to_v_ip", bias=False)
        # learnable image-branch scale (attention.py:77-78); optional
        entries.append((jp + ("alpha",), tp + ".alpha", t_none))
    # optional temporal relative-position tables (attention.py:20-39);
    # skipped automatically when the model topology doesn't have them
    entries.append((jp + ("relative_position_k",),
                    tp + ".relative_position_k.embeddings_table", t_none))
    entries.append((jp + ("relative_position_v",),
                    tp + ".relative_position_v.embeddings_table", t_none))


def _transformer_block(entries, jp, tp, image_branch=False):
    _norm(entries, jp + ("norm1",), tp + ".norm1")
    _norm(entries, jp + ("norm2",), tp + ".norm2")
    _norm(entries, jp + ("norm3",), tp + ".norm3")
    _cross_attention(entries, jp + ("attn1",), tp + ".attn1")
    _cross_attention(entries, jp + ("attn2",), tp + ".attn2",
                     image_branch=image_branch)
    _dense(entries, jp + ("ff", "geglu", "proj"), tp + ".ff.net.0.proj")
    _dense(entries, jp + ("ff", "out"), tp + ".ff.net.2")


def _spatial_transformer(entries, jp, tp, depth=1, image_branch=True,
                         linear_proj=True):
    _norm(entries, jp + ("norm",), tp + ".norm")
    if linear_proj:
        _dense(entries, jp + ("proj_in",), tp + ".proj_in")
        _dense(entries, jp + ("proj_out",), tp + ".proj_out")
    else:
        # use_linear=False -> Conv1d(k=1) projections (attention.py:333-336);
        # the UNet's init_attn is built without use_linear
        # (openaimodel3d.py:390-399)
        for n in ("proj_in", "proj_out"):
            entries.append((jp + (n, "kernel"), f"{tp}.{n}.weight", t_conv1d1))
            entries.append((jp + (n, "bias"), f"{tp}.{n}.bias", t_none))
    for d in range(depth):
        _transformer_block(entries, jp + (f"block_{d}",),
                           tp + f".transformer_blocks.{d}",
                           image_branch=image_branch)


def _temporal_transformer(entries, jp, tp, depth=1, linear_proj=True):
    _spatial_transformer(entries, jp, tp, depth, image_branch=False,
                         linear_proj=linear_proj)


def _unet_resblock(entries, jp, tp, temporal=True):
    _norm(entries, jp + ("in_norm",), tp + ".in_layers.0")
    _conv(entries, jp + ("in_conv",), tp + ".in_layers.2")
    _dense(entries, jp + ("emb_proj",), tp + ".emb_layers.1")
    _norm(entries, jp + ("out_norm",), tp + ".out_layers.0")
    _conv(entries, jp + ("out_conv",), tp + ".out_layers.3")
    # skip 1x1 conv exists only on channel change; emitted opportunistically
    _dense_from_1x1(entries, jp + ("skip",), tp + ".skip_connection")
    if temporal:
        # note: reference attribute is misspelled 'temopral_conv'
        tt = tp + ".temopral_conv"
        for i in (1, 2, 3, 4):
            seq_idx = 2 if i == 1 else 3  # Sequential conv position
            _norm(entries, jp + ("temporal_conv", f"norm{i}"),
                  f"{tt}.conv{i}.0")
            _conv(entries, jp + ("temporal_conv", f"conv{i}"),
                  f"{tt}.conv{i}.{seq_idx}", nd=3)


def unet_mapping(channel_mult=(1, 2, 4, 4), num_res_blocks=2,
                 attention_resolutions=(4, 2, 1)) -> List[Entry]:
    e: List[Entry] = []
    p = "model.diffusion_model"
    for idx in (0, 2):
        _dense(e, (f"time_embed_{idx}",), f"{p}.time_embed.{idx}")
        _dense(e, (f"fps_embedding_{idx}",), f"{p}.fps_embedding.{idx}")
    _conv(e, ("input_conv",), f"{p}.input_blocks.0.0")
    _temporal_transformer(e, ("init_attn",), f"{p}.init_attn.0",
                          linear_proj=False)

    tb = 1
    ds = 1
    for level in range(len(channel_mult)):
        for i in range(num_res_blocks):
            base = f"{p}.input_blocks.{tb}"
            _unet_resblock(e, (f"in_{level}_{i}_res",), base + ".0")
            if ds in attention_resolutions:
                _spatial_transformer(e, (f"in_{level}_{i}_spatial",),
                                     base + ".1")
                _temporal_transformer(e, (f"in_{level}_{i}_temporal",),
                                      base + ".2")
            tb += 1
        if level != len(channel_mult) - 1:
            _conv(e, (f"down_{level}", "op"), f"{p}.input_blocks.{tb}.0.op")
            tb += 1
            ds *= 2

    _unet_resblock(e, ("mid_res_0",), f"{p}.middle_block.0")
    _spatial_transformer(e, ("mid_spatial",), f"{p}.middle_block.1")
    _temporal_transformer(e, ("mid_temporal",), f"{p}.middle_block.2")
    _unet_resblock(e, ("mid_res_1",), f"{p}.middle_block.3")

    ob = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            base = f"{p}.output_blocks.{ob}"
            _unet_resblock(e, (f"out_{level}_{i}_res",), base + ".0")
            pos = 1
            if ds in attention_resolutions:
                _spatial_transformer(e, (f"out_{level}_{i}_spatial",),
                                     base + f".{pos}")
                _temporal_transformer(e, (f"out_{level}_{i}_temporal",),
                                      base + f".{pos + 1}")
                pos += 2
            if level and i == num_res_blocks:
                _conv(e, (f"up_{level}", "conv"), base + f".{pos}.conv")
                ds //= 2
            ob += 1

    _norm(e, ("out_norm",), f"{p}.out.0")
    _conv(e, ("out_conv",), f"{p}.out.2")
    return e


def _ae_resblock(entries, jp, tp):
    _norm(entries, jp + ("norm1",), tp + ".norm1")
    _conv(entries, jp + ("conv1",), tp + ".conv1")
    _norm(entries, jp + ("norm2",), tp + ".norm2")
    _conv(entries, jp + ("conv2",), tp + ".conv2")
    _dense_from_1x1(entries, jp + ("nin_shortcut",), tp + ".nin_shortcut")


def _ae_attn(entries, jp, tp):
    _norm(entries, jp + ("norm",), tp + ".norm")
    for n in ("q", "k", "v", "proj_out"):
        _dense_from_1x1(entries, jp + (n,), f"{tp}.{n}")


def vae_encoder_mapping(ch_mult=(1, 2, 4, 4), num_res_blocks=2) -> List[Entry]:
    e: List[Entry] = []
    p = "first_stage_model"
    _conv(e, ("encoder", "conv_in"), f"{p}.encoder.conv_in")
    for l in range(len(ch_mult)):
        for i in range(num_res_blocks):
            _ae_resblock(e, ("encoder", f"down_{l}", f"block_{i}"),
                         f"{p}.encoder.down.{l}.block.{i}")
        if l != len(ch_mult) - 1:
            _conv(e, ("encoder", f"down_{l}", "downsample", "conv"),
                  f"{p}.encoder.down.{l}.downsample.conv")
    _ae_resblock(e, ("encoder", "mid_block_1"), f"{p}.encoder.mid.block_1")
    _ae_attn(e, ("encoder", "mid_attn_1"), f"{p}.encoder.mid.attn_1")
    _ae_resblock(e, ("encoder", "mid_block_2"), f"{p}.encoder.mid.block_2")
    _norm(e, ("encoder", "norm_out"), f"{p}.encoder.norm_out")
    _conv(e, ("encoder", "conv_out"), f"{p}.encoder.conv_out")
    _dense_from_1x1(e, ("quant_conv",), f"{p}.quant_conv")
    _dense_from_1x1(e, ("post_quant_conv",), f"{p}.post_quant_conv")
    return e


def _video_resblock(entries, jp, tp):
    _ae_resblock(entries, jp + ("spatial",), tp)
    _norm(entries, jp + ("time_stack", "in_norm"), tp + ".time_stack.in_layers.0")
    _conv(entries, jp + ("time_stack", "in_conv"),
          tp + ".time_stack.in_layers.2", nd=3)
    _norm(entries, jp + ("time_stack", "out_norm"),
          tp + ".time_stack.out_layers.0")
    _conv(entries, jp + ("time_stack", "out_conv"),
          tp + ".time_stack.out_layers.3", nd=3)
    entries.append((jp + ("mix_factor",), tp + ".mix_factor", t_none))


def _svd_ff(entries, jp, tp):
    """attention_svd FeedForward(glu=True): net.0=GEGLU(proj), net.2=Linear."""
    _dense(entries, jp + ("proj",), tp + ".net.0.proj")
    _dense(entries, jp + ("out",), tp + ".net.2")


def _svd_temporal_block(entries, jp, tp):
    """VideoTransformerBlock (autoencoder_dualref.py:703-833) with
    ff_in=True, single head, self-attn twice."""
    _norm(entries, jp + ("norm_in",), tp + ".norm_in")
    _svd_ff(entries, jp + ("ff_in",), tp + ".ff_in")
    for a in ("attn1", "attn2"):
        for n in ("to_q", "to_k", "to_v"):
            _dense(entries, jp + (f"{a}_{n}",), f"{tp}.{a}.{n}", bias=False)
        _dense(entries, jp + (f"{a}_to_out",), f"{tp}.{a}.to_out.0")
    for n in ("norm1", "norm2", "norm3"):
        _norm(entries, jp + (n,), f"{tp}.{n}")
    _svd_ff(entries, jp + ("ff",), tp + ".ff")


def _time_attn_block(entries, jp, tp):
    """VideoBlock / MemoryEfficientVideoBlock (autoencoder_dualref.py:
    938-1075): spatial attn + video_time_embed MLP + temporal transformer
    + mix_factor."""
    _norm(entries, jp + ("norm",), tp + ".norm")
    for n in ("q", "k", "v", "proj_out"):
        _dense_from_1x1(entries, jp + (n,), f"{tp}.{n}")
    _dense(entries, jp + ("video_time_embed_0",), tp + ".video_time_embed.0")
    _dense(entries, jp + ("video_time_embed_2",), tp + ".video_time_embed.2")
    entries.append((jp + ("mix_factor",), tp + ".mix_factor", t_none))
    _svd_temporal_block(entries, jp + ("time_mix_block",),
                        tp + ".time_mix_block")


def dualref_decoder_mapping(ch_mult=(1, 2, 4, 4), num_res_blocks=2,
                            attn_level=(2, 3),
                            time_mode="conv-only") -> List[Entry]:
    e: List[Entry] = []
    p = "first_stage_model.decoder"
    time_attn = time_mode in ("all", "attn-only")
    time_res = time_mode != "attn-only"

    def resblock(jp, tp):
        if time_res:
            _video_resblock(e, jp, tp)
        else:  # attn-only: plain spatial ResnetBlock
            _ae_resblock(e, jp + ("spatial",), tp)

    _conv(e, ("conv_in",), f"{p}.conv_in")
    resblock(("mid_block_1",), f"{p}.mid.block_1")
    if time_attn:
        _time_attn_block(e, ("mid_attn_1",), f"{p}.mid.attn_1")
    else:
        _ae_attn(e, ("mid_attn_1", "attn"), f"{p}.mid.attn_1")
    resblock(("mid_block_2",), f"{p}.mid.block_2")
    for l in reversed(range(len(ch_mult))):
        for i in range(num_res_blocks + 1):
            resblock((f"up_{l}_block_{i}",), f"{p}.up.{l}.block.{i}")
        if l != 0:
            _conv(e, (f"up_{l}_upsample", "conv"),
                  f"{p}.up.{l}.upsample.conv")
        rp = f"{p}.attn_refinement.{l}"
        if l in attn_level:
            _norm(e, (f"inject_{l}", "norm"), rp + ".norm")
            _dense(e, (f"inject_{l}", "to_q"), rp + ".to_q", bias=False)
            _dense(e, (f"inject_{l}", "to_k"), rp + ".to_k", bias=False)
            _dense(e, (f"inject_{l}", "to_v"), rp + ".to_v", bias=False)
            _dense(e, (f"inject_{l}", "to_out"), rp + ".to_out.0")
        else:
            _dense_from_1x1(e, (f"inject_{l}", "conv"), rp + ".conv")
    _norm(e, ("norm_out",), f"{p}.norm_out")
    _dense_from_1x1(e, ("inject_out", "conv"),
                    f"{p}.attn_refinement.{len(ch_mult)}.conv")
    _conv(e, ("conv_out", "conv"), f"{p}.conv_out")
    if time_res:
        _conv(e, ("conv_out", "time_mix_conv"),
              f"{p}.conv_out.time_mix_conv", nd=3)
    return e


def vae_plain_decoder_mapping(ch_mult=(1, 2, 4, 4),
                              num_res_blocks=2) -> List[Entry]:
    """Plain (non-dualref) decoder — present in AutoencoderKL checkpoints
    (DynamiCrafter family); the ToonCrafter ckpt replaces it with the
    VideoDecoder, in which case these keys don't exist."""
    e: List[Entry] = []
    p = "first_stage_model.decoder"
    _conv(e, ("decoder", "conv_in"), f"{p}.conv_in")
    _ae_resblock(e, ("decoder", "mid_block_1"), f"{p}.mid.block_1")
    _ae_attn(e, ("decoder", "mid_attn_1"), f"{p}.mid.attn_1")
    _ae_resblock(e, ("decoder", "mid_block_2"), f"{p}.mid.block_2")
    for l in reversed(range(len(ch_mult))):
        for i in range(num_res_blocks + 1):
            _ae_resblock(e, ("decoder", f"up_{l}", f"block_{i}"),
                         f"{p}.up.{l}.block.{i}")
        if l != 0:
            _conv(e, ("decoder", f"up_{l}", "upsample", "conv"),
                  f"{p}.up.{l}.upsample.conv")
    _norm(e, ("decoder", "norm_out"), f"{p}.norm_out")
    _conv(e, ("decoder", "conv_out"), f"{p}.conv_out")
    return e


def clip_text_mapping(layers=24, penultimate=True) -> List[Entry]:
    e: List[Entry] = []
    p = "cond_stage_model.model"
    e.append((("token_embedding", "embedding"),
              f"{p}.token_embedding.weight", t_none))
    e.append((("positional_embedding",), f"{p}.positional_embedding", t_none))
    n_run = layers - (1 if penultimate else 0)
    for i in range(n_run):
        b = f"{p}.transformer.resblocks.{i}"
        jp = (f"resblock_{i}",)
        _norm(e, jp + ("ln_1",), b + ".ln_1")
        _norm(e, jp + ("ln_2",), b + ".ln_2")
        e.append((jp + ("attn", "in_proj", "kernel"),
                  b + ".attn.in_proj_weight", t_linear))
        e.append((jp + ("attn", "in_proj", "bias"),
                  b + ".attn.in_proj_bias", t_none))
        _dense(e, jp + ("attn", "out_proj"), b + ".attn.out_proj")
        _dense(e, jp + ("mlp_c_fc",), b + ".mlp.c_fc")
        _dense(e, jp + ("mlp_c_proj",), b + ".mlp.c_proj")
    _norm(e, ("ln_final",), f"{p}.ln_final")
    return e


def clip_vision_mapping(layers=32) -> List[Entry]:
    e: List[Entry] = []
    p = "embedder.model.visual"
    e.append((("class_embedding",), f"{p}.class_embedding", t_none))
    e.append((("positional_embedding",), f"{p}.positional_embedding", t_none))
    e.append((("conv1", "kernel"), f"{p}.conv1.weight", t_conv2d))
    _norm(e, ("ln_pre",), f"{p}.ln_pre")
    for i in range(layers):
        b = f"{p}.transformer.resblocks.{i}"
        jp = (f"resblock_{i}",)
        _norm(e, jp + ("ln_1",), b + ".ln_1")
        _norm(e, jp + ("ln_2",), b + ".ln_2")
        e.append((jp + ("attn", "in_proj", "kernel"),
                  b + ".attn.in_proj_weight", t_linear))
        e.append((jp + ("attn", "in_proj", "bias"),
                  b + ".attn.in_proj_bias", t_none))
        _dense(e, jp + ("attn", "out_proj"), b + ".attn.out_proj")
        _dense(e, jp + ("mlp_c_fc",), b + ".mlp.c_fc")
        _dense(e, jp + ("mlp_c_proj",), b + ".mlp.c_proj")
    return e


def resampler_mapping(depth=4) -> List[Entry]:
    e: List[Entry] = []
    p = "image_proj_model"
    e.append((("latents",), f"{p}.latents", t_none))
    _dense(e, ("proj_in",), f"{p}.proj_in")
    _dense(e, ("proj_out",), f"{p}.proj_out")
    _norm(e, ("norm_out",), f"{p}.norm_out")
    for i in range(depth):
        a = f"{p}.layers.{i}.0"
        jp = (f"layer_{i}_attn",)
        _norm(e, jp + ("norm1",), a + ".norm1")
        _norm(e, jp + ("norm2",), a + ".norm2")
        _dense(e, jp + ("to_q",), a + ".to_q", bias=False)
        _dense(e, jp + ("to_kv",), a + ".to_kv", bias=False)
        _dense(e, jp + ("to_out",), a + ".to_out", bias=False)
        f = f"{p}.layers.{i}.1"
        jp = (f"layer_{i}_ff",)
        _norm(e, jp + ("norm",), f + ".0")
        _dense(e, jp + ("fc1",), f + ".1", bias=False)
        _dense(e, jp + ("fc2",), f + ".3", bias=False)
    return e


# ---------------------------------------------------------------------------
# the full mapping
# ---------------------------------------------------------------------------

def is_dualref_checkpoint(sd: Dict[str, np.ndarray]) -> bool:
    # time_mix_conv covers 'conv-only'/'all'; attn_refinement covers
    # 'attn-only' (which has no temporal convs at all)
    return any("time_mix_conv" in k or "attn_refinement" in k for k in sd)


def full_mapping(config, dualref: bool = True) -> Dict[str, List[Entry]]:
    """Per-tower mapping entries for a ModelConfig.

    dualref selects how `first_stage_model.decoder.*` is interpreted: the
    VideoDecoder (ToonCrafter ckpt) or the plain SD decoder (DynamiCrafter
    ckpt)."""
    mapping = {
        "unet": unet_mapping(tuple(config.channel_mult),
                             config.num_res_blocks,
                             tuple(config.attention_resolutions)),
        "vae": vae_encoder_mapping(tuple(config.vae_ch_mult),
                                   config.vae_num_res_blocks),
        "text_encoder": clip_text_mapping(config.clip_text_layers),
        "image_encoder": clip_vision_mapping(config.clip_vision_layers),
        "image_proj": resampler_mapping(config.resampler_depth),
    }
    if dualref:
        mapping["dualref_decoder"] = dualref_decoder_mapping(
            tuple(config.vae_ch_mult), config.vae_num_res_blocks,
            tuple(config.dualref_attn_level),
            getattr(config, "dualref_time_mode", "conv-only"))
    else:
        mapping["vae"] = mapping["vae"] + vae_plain_decoder_mapping(
            tuple(config.vae_ch_mult), config.vae_num_res_blocks)
    return mapping
