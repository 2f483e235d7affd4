"""The port's kernel-backed ops (no registry yet: the kernel is picked by
the device of the tensors)."""
from .base import (act_scale, fake_quant, fake_quant_weight, hash_eps,
                   noise_inject, packed_matmul, packed_matmul_grouped,
                   qkv_attn_decode, qkv_attn_decode_paged,
                   quantize_pack_mixed)

__all__ = ["act_scale", "fake_quant", "fake_quant_weight", "hash_eps",
           "noise_inject", "packed_matmul", "packed_matmul_grouped",
           "qkv_attn_decode", "qkv_attn_decode_paged", "quantize_pack_mixed"]
