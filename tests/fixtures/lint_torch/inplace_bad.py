"""Fixture: stale aliases read after in-place writes (D6xx)."""
import torch


def _copy_into(dst, src):
    for k in dst:
        dst[k].copy_(src[k])


def head_after_copy(buf, new):
    head = buf[0]
    buf.copy_(new)
    return head.sum()


def view_after_tree_copy(state, new):
    keys = state["k"][:, :2]
    _copy_into(state, new)
    return keys + 1


def out_into(a, b, acc):
    row = acc[1]
    torch.add(a, b, out=acc)
    return row
