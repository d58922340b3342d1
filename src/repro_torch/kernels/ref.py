"""Plain PyTorch versions of the two CUDA kernels (the CPU path and the oracle).

Bit-identical to the jnp references of the JAX package (``repro/kernels/
ref.py``).  Every uint32 column (key/string hash lanes, string prefixes,
``u0``/``u1``) is carried as an int32 *view*: equality and bitwise AND are
the same on either view, and the STR_PREFIX masks are built in int64 so
that XLA's shift semantics (a logical shift by >= 32 gives 0) are
reproduced exactly.
"""

from __future__ import annotations

import torch

from ..core.nodetypes import T_ARR, T_BOOL, T_NULL, T_NUM, T_OBJ, T_STR
from ..core.tape import AOP

__all__ = ["hash_match_ref", "assertion_eval_window_ref"]

_BIG = 2**30
_U32 = 0xFFFFFFFF


def hash_match_ref(
    q_lanes: torch.Tensor,  # (N, 8) int32 view of uint32 lanes
    q_owner: torch.Tensor,  # (N,)   int32, -1 = padding (never matches)
    t_lanes: torch.Tensor,  # (M, 8) int32 view of uint32 lanes
    t_owner: torch.Tensor,  # (M,)   int32, -9 = padding
) -> torch.Tensor:
    """(N,) int32: minimal table row whose 8 lanes and owner match, else -1.

    A query with owner -1 (the padding owner) matches nothing; table owners
    are >= 0 or the -9 padding owner, so this equals the jnp reference.
    """
    n, m = q_lanes.shape[0], t_lanes.shape[0]
    if m == 0:
        return torch.full((n,), -1, dtype=torch.int32, device=q_lanes.device)
    matched = q_owner[:, None] == t_owner[None, :]  # (N, M)
    for lane in range(8):  # eight rank-2 compares, no (N, M, 8) intermediate
        matched &= q_lanes[:, lane, None] == t_lanes[None, :, lane]
    matched &= (q_owner != -1)[:, None]
    rows = torch.arange(m, dtype=torch.int32, device=q_lanes.device)
    best = torch.where(matched, rows[None, :], _BIG).min(dim=1).values
    return torch.where(best >= _BIG, -1, best)


def _prefix_mask(length: torch.Tensor) -> torch.Tensor:
    """int64 byte mask of the first ``length`` bytes of a big-endian word.

    Mirrors ``where(len == 0, 0, (full >> s) << s)`` with ``s = (4 - len) * 8``
    taken as uint32, where a shift by 32 or more yields 0.
    """
    shift = ((4 - length) * 8).to(torch.int64) & _U32
    small = torch.clamp(shift, max=31)
    mask = ((_U32 >> small) << small) & _U32
    mask = torch.where(shift >= 32, torch.zeros_like(mask), mask)
    return torch.where(length == 0, torch.zeros_like(mask), mask)


def _eval_rows_ref(ntype, isint, num, size, acq, pfx0, pfx1, op, f0, i0, i1, u0, u1, hash_eq):
    """Branch-free mini-ISA evaluation on broadcastable operands.

    Node operands are (N, 1), window operands (N, W); ``hash_eq`` is the
    8-lane string-hash equality at the output shape.  Integer operands are
    int32 (u32 ones as int32 views), ``num``/``f0`` float32.
    """
    out_shape = hash_eq.shape
    is_num = ntype == T_NUM
    is_str = ntype == T_STR
    is_arr = ntype == T_ARR
    is_obj = ntype == T_OBJ

    # TYPE_MASK: 1 << ntype, 0 outside [0, 31] (XLA shift semantics)
    in_range = (ntype >= 0) & (ntype < 32)
    type_bit = torch.where(
        in_range,
        torch.bitwise_left_shift(torch.ones_like(ntype), torch.clamp(ntype, 0, 31)),
        torch.zeros_like(ntype),
    )
    r_type = ((type_bit & i0) != 0) & ((i1 == 0) | ~is_num | isint)

    r_ge = ~is_num | (num >= f0)
    r_gt = ~is_num | (num > f0)
    r_le = ~is_num | (num <= f0)
    r_lt = ~is_num | (num < f0)
    # NUM_MULTIPLE: float32 quotient within min(1e-6 * max(|q|, 1), 0.25)
    # of an integer (DESIGN.md §7); every constant is a float32 tensor
    one = torch.ones((), dtype=torch.float32, device=num.device)
    q = num / torch.where(f0 == 0, one, f0)
    q_near = torch.floor(q + torch.tensor(0.5, dtype=torch.float32, device=num.device))
    q_tol = torch.minimum(
        torch.tensor(1e-6, dtype=torch.float32, device=num.device)
        * torch.maximum(torch.abs(q), one),
        torch.tensor(0.25, dtype=torch.float32, device=num.device),
    )
    r_mul = ~is_num | ((f0 != 0) & (torch.abs(q - q_near) <= q_tol))

    r_str_min = ~is_str | (size >= i0)
    r_str_max = ~is_str | (size <= i0)
    r_arr_min = ~is_arr | (size >= i0)
    r_arr_max = ~is_arr | (size <= i0)
    r_obj_min = ~is_obj | (size >= i0)
    r_obj_max = ~is_obj | (size <= i0)

    # STR_PREFIX: masked compare of the first i0 (<= 8) big-endian bytes
    m0 = _prefix_mask(torch.clamp(i0, max=4))
    m1 = _prefix_mask(torch.clamp(i0 - 4, min=0))
    pfx_eq = ((pfx0.to(torch.int64) & m0) == (u0.to(torch.int64) & m0)) & (
        (pfx1.to(torch.int64) & m1) == (u1.to(torch.int64) & m1)
    )
    r_prefix = ~is_str | (pfx_eq & (size >= i0))

    r_str_eq = is_str & hash_eq
    r_str_eq_pre = ~is_str | hash_eq
    r_null = (ntype == T_NULL).expand(out_shape)
    r_bool = (ntype == T_BOOL) & (num == f0)
    r_num_const = is_num & (num == f0)

    # OBJ_HAS_SLOT: acquired required-slot bit clip(i0, 0, 31)
    slot_bit = (torch.bitwise_right_shift(acq, torch.clamp(i0, 0, 31)) & 1) != 0
    r_has_slot = ~is_obj | slot_bit

    result = torch.zeros(out_shape, dtype=torch.bool, device=hash_eq.device)
    for code, value in [
        (AOP.TYPE_MASK, r_type),
        (AOP.NUM_GE, r_ge),
        (AOP.NUM_GT, r_gt),
        (AOP.NUM_LE, r_le),
        (AOP.NUM_LT, r_lt),
        (AOP.NUM_MULTIPLE, r_mul),
        (AOP.STR_MINLEN, r_str_min),
        (AOP.STR_MAXLEN, r_str_max),
        (AOP.ARR_MINLEN, r_arr_min),
        (AOP.ARR_MAXLEN, r_arr_max),
        (AOP.OBJ_MINPROPS, r_obj_min),
        (AOP.OBJ_MAXPROPS, r_obj_max),
        (AOP.STR_PREFIX, r_prefix),
        (AOP.STR_EQ, r_str_eq),
        (AOP.CONST_NULL, r_null),
        (AOP.CONST_BOOL, r_bool),
        (AOP.CONST_NUM, r_num_const),
        (AOP.STR_EQ_PRE, r_str_eq_pre),
        (AOP.OBJ_HAS_SLOT, r_has_slot),
    ]:
        result = torch.where(op == code, value.expand(out_shape), result)
    return result


def assertion_eval_window_ref(node_cols: dict, w_cols: dict) -> torch.Tensor:
    """(N, W) int8 pass matrix of each node against its gathered CSR window.

    ``node_cols``: type/is_int/size/acquired int32 (N,), num float32 (N,),
    str_hash int32 (N, 8), str_prefix int32 (N, 2).  ``w_cols``: op/i0/i1/
    u0/u1 int32 (N, W), f0 float32 (N, W), hash int32 (N, W, 8).  Slots
    with op -1 evaluate to 0.
    """
    str_hash = node_cols["str_hash"]
    str_pfx = node_cols["str_prefix"]
    w_hash = w_cols["hash"]
    hash_eq = torch.ones(w_cols["op"].shape, dtype=torch.bool, device=w_hash.device)
    for lane in range(8):
        hash_eq &= str_hash[:, lane, None] == w_hash[:, :, lane]
    result = _eval_rows_ref(
        node_cols["type"][:, None],
        node_cols["is_int"][:, None] != 0,
        node_cols["num"][:, None],
        node_cols["size"][:, None],
        node_cols["acquired"][:, None],
        str_pfx[:, 0:1],
        str_pfx[:, 1:2],
        w_cols["op"],
        w_cols["f0"],
        w_cols["i0"],
        w_cols["i1"],
        w_cols["u0"],
        w_cols["u1"],
        hash_eq,
    )
    return result.to(torch.int8)
