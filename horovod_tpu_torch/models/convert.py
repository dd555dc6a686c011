"""Weight conversion: Hugging Face Llama, Mistral and Mixtral state dicts
to and from :mod:`.llama`'s parameters.

Port of ``horovod_tpu/models/convert.py:1-202``.  The Hugging Face
``LlamaForCausalLM`` / ``MistralForCausalLM`` / ``MixtralForCausalLM``
names map onto the parameter dictionary :func:`.llama.init_params` makes,
with the one layout difference between them:

- **Linear orientation**: ``nn.Linear`` stores ``[out, in]``; the port's
  products are ``x @ W`` with ``W [in, out]``, so every projection is
  transposed (into a new contiguous tensor on the tensor's own device).
- **Rotary layout**: none.  Hugging Face's ``rotate_half`` rope splits the
  head in halves as ``llama._rope`` does, so q and k convert by the
  transpose alone (``tests/test_torch_convert.py`` holds the logits to
  ``transformers``').

Input: a mapping of ``str`` to torch tensors (on any device, any dtype) or
numpy arrays (bfloat16 ones as ``ml_dtypes`` arrays).  A tensor on the card
stays there: nothing goes through numpy.  Output: the tree
:func:`.llama.init_params` makes (stacked for a ``pp_axis`` config), in
``cfg.dtype``, with leaves that do not require grad.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from .llama import LlamaConfig, _to_tensor, stack_layers


def _tensor(x, device) -> torch.Tensor:
    t = x.detach() if isinstance(x, torch.Tensor) else _to_tensor(x, None,
                                                                  None)
    return t if device is None else t.to(device)


def from_hf_state_dict(sd: Mapping[str, Any], cfg: LlamaConfig,
                       device=None) -> Dict:
    """Map a Hugging Face Llama, Mistral or Mixtral state dict onto
    :func:`.llama.init_params`'s tree, on ``device`` (each tensor's own
    device by default).

    Expects the standard names (``model.layers.N.self_attn.q_proj.weight``
    and so on; ``block_sparse_moe.*`` for a config with ``n_experts``);
    raises ``KeyError`` naming the first missing tensor and ``ValueError``
    on tensors left unconsumed (a 32-layer checkpoint against
    ``n_layers=16``, or attention biases this architecture lacks, must not
    convert into a wrong model).  Without ``lm_head.weight`` the head is
    the embedding's transpose (tied embeddings).  Leaves are in
    ``cfg.dtype``; match ``cfg.norm_eps`` to the checkpoint's
    ``rms_norm_eps``."""
    if cfg.n_experts and not (cfg.moe_gated and cfg.router_top_k >= 2):
        raise ValueError(
            "MoE conversion expects the Mixtral shape: moe_gated=True "
            "(SwiGLU experts) with router_top_k >= 2 (normalized top-k "
            "gates — top-1 Switch routing over top-2-trained weights "
            "would be silently wrong) — see mixtral_8x7b()")
    dt = cfg.dtype
    consumed = set()

    def get(name):
        if name not in sd:
            raise KeyError(
                f"state dict is missing {name!r} — is this a "
                f"LlamaForCausalLM/MistralForCausalLM checkpoint with "
                f"n_layers={cfg.n_layers}?")
        consumed.add(name)
        return _tensor(sd[name], device).to(dt)

    def plain(name):
        return get(name).clone()

    def linear(name):                   # [out, in] -> x @ W [in, out]
        return get(name).t().clone(memory_format=torch.contiguous_format)

    layers = []
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        layer = {
            "attn_norm": plain(pre + "input_layernorm.weight"),
            "wq": linear(pre + "self_attn.q_proj.weight"),
            "wk": linear(pre + "self_attn.k_proj.weight"),
            "wv": linear(pre + "self_attn.v_proj.weight"),
            "wo": linear(pre + "self_attn.o_proj.weight"),
            "mlp_norm": plain(pre + "post_attention_layernorm.weight"),
        }
        if cfg.n_experts:
            # Mixtral's sparse block: per-expert SwiGLU (w1 gate, w3 up, w2
            # down, each [out, in]) and the router's gate, stacked onto the
            # port's [E, ...] slabs.
            moe_pre = pre + "block_sparse_moe."
            layer["moe"] = {"router": linear(moe_pre + "gate.weight")}
            for w in ("w1", "w3", "w2"):
                layer["moe"][w] = torch.stack(
                    [linear(f"{moe_pre}experts.{e}.{w}.weight")
                     for e in range(cfg.n_experts)])
        else:
            layer |= {"w1": linear(pre + "mlp.gate_proj.weight"),
                      "w3": linear(pre + "mlp.up_proj.weight"),
                      "w2": linear(pre + "mlp.down_proj.weight")}
        layers.append(layer)

    embed = plain("model.embed_tokens.weight")
    if "lm_head.weight" in sd:
        head = linear("lm_head.weight")
    else:
        head = embed.t().contiguous()       # tie_word_embeddings=True
    norm = plain("model.norm.weight")

    extra = [k for k in sd
             if k not in consumed and "rotary_emb.inv_freq" not in k]
    if extra:
        raise ValueError(
            f"{len(extra)} checkpoint tensor(s) were not consumed — the "
            f"config does not describe this checkpoint (wrong n_layers? "
            f"an architecture with biases?).  First few: "
            f"{sorted(extra)[:4]}")
    params = {"embed": embed, "layers": layers, "final_norm": norm,
              "lm_head": head}
    return stack_layers(params) if cfg.pp_axis else params


def to_hf_state_dict(params: Dict, cfg: LlamaConfig,
                     tied_embeddings: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """The inverse mapping: the port's tree back to Hugging Face names and
    orientation, each tensor in its leaf's dtype on its leaf's device (for
    exporting fine-tuned weights).  ``tied_embeddings=True`` omits
    ``lm_head.weight`` and refuses a head that is not the embedding's
    transpose.  The stacked pp layout and the MoE layout are refused, as
    in the JAX package."""
    if cfg.pp_axis:
        raise ValueError("export from the stacked pp layout is not "
                         "supported; rebuild params with pp_axis=None")
    if cfg.n_experts:
        raise ValueError("to_hf_state_dict export for the MoE/Mixtral "
                         "layout (block_sparse_moe.*) is not yet "
                         "implemented — only the dense Llama/Mistral "
                         "shape exports; import via from_hf_state_dict "
                         "supports both")

    def plain(t):
        return t.detach().clone()

    def linear(t):
        return t.detach().t().clone(memory_format=torch.contiguous_format)

    sd: Dict[str, torch.Tensor] = {
        "model.embed_tokens.weight": plain(params["embed"]),
        "model.norm.weight": plain(params["final_norm"]),
    }
    if tied_embeddings:
        # A head that diverged from the embedding (fine-tuning breaks the
        # tie) must not be dropped silently.
        if not torch.allclose(params["lm_head"].detach().float(),
                              params["embed"].detach().float().t(),
                              rtol=1e-5, atol=1e-6):
            raise ValueError(
                "tied_embeddings=True but params['lm_head'] != "
                "embed.T — exporting would discard trained head "
                "weights; export untied instead")
    else:
        sd["lm_head.weight"] = linear(params["lm_head"])
    for i, lp in enumerate(params["layers"]):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = plain(lp["attn_norm"])
        sd[pre + "post_attention_layernorm.weight"] = plain(lp["mlp_norm"])
        for name, key in (("self_attn.q_proj", "wq"),
                          ("self_attn.k_proj", "wk"),
                          ("self_attn.v_proj", "wv"),
                          ("self_attn.o_proj", "wo"),
                          ("mlp.gate_proj", "w1"), ("mlp.up_proj", "w3"),
                          ("mlp.down_proj", "w2")):
            sd[f"{pre}{name}.weight"] = linear(lp[key])
    return sd
