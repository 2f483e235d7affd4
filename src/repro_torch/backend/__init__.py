"""Serve-path driver of the port (no registry yet: the kernel is picked by
the device of the tensors)."""
from .base import (act_scale, packed_matmul, qkv_attn_decode,
                   qkv_attn_decode_paged, quantize_pack_mixed)

__all__ = ["act_scale", "packed_matmul", "qkv_attn_decode",
           "qkv_attn_decode_paged", "quantize_pack_mixed"]
