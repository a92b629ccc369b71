"""Checkpoints: named trees -> npz + msgpack meta, in the reference's format
(port of ``repro/checkpoint/checkpointing.py``).

A checkpoint written by either package loads in the other: the arrays are
keyed ``{tree}::{path}`` with the reference's ``_flatten_with_paths``
strings (``embed``, ``layers/0/w``, ``.anchor/embed``, ``.count``, the
six children of ``ExchangeState`` as ``0`` .. ``5``), the meta holds the
same map (step, per-tree keys / dtypes / shapes / crc32 / treedef string,
extra) and is encoded byte for byte as ``msgpack.packb`` encodes it, by a
small codec of this module (maps, strings, ints, floats, None, bools
and lists, the subset the metas use; the serve engine's snapshot extra
holds the last four): the card's machine has no ``msgpack``.

Trees are built the reference's way: dicts (flattened by sorted key),
tuples and lists, None, NamedTuples (``QGenXOptState``, ``AdamState``:
fields keyed ``.name``) and :class:`repro_torch.core.exchange.ExchangeState`
(its six children by index).  Leaves are torch tensors, numpy arrays or
host ints (the port's optimizer ``count`` and exchange ``step``, saved as
the reference's int32 0-d arrays and restored as ints).  bf16 tensors are
saved as the 2-byte void array numpy writes for the reference's bf16
leaves (dtype ``bfloat16`` in the meta) and restored bit for bit without
``ml_dtypes``; :mod:`repro_torch.convert` builds the trees from the
port's model and states.

Crash safety, as in the reference: every file lands by ``tmp +
os.replace``, in the order npz -> meta -> ``latest``; the meta records a
crc32 per array and :func:`restore` re-hashes on load;
:func:`restore_with_fallback` walks back from the newest checkpoint to
the newest intact one.  :class:`CheckpointCorruptError` (unreadable,
truncated or crc-mismatched: an older step may be intact) and
:class:`CheckpointStructureError` (intact but not matching the templates:
the run configuration changed) are the failure types.
"""

from __future__ import annotations

import os
import struct
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core import retry as retry_mod


class CheckpointError(Exception):
    """Base class for checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """Missing/truncated/crc-mismatched files — an older step may be intact."""


class CheckpointStructureError(CheckpointError):
    """Intact checkpoint, incompatible with the restore templates."""

    def __init__(self, tree: str, detail: str):
        self.tree = tree
        self.detail = detail
        super().__init__(f"checkpoint tree {tree!r} incompatible: {detail}")


# ---------------------------------------------------------------------------
# msgpack, the subset the meta uses
# ---------------------------------------------------------------------------


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for maps, strings, ints, floats (as float 64),
    None, bools and lists / tuples (the same bytes)."""
    out = bytearray()

    def rec(o):
        if o is None:
            out.append(0xC0)
        elif isinstance(o, (bool, np.bool_)):
            out.append(0xC3 if o else 0xC2)
        elif isinstance(o, (float, np.floating)):
            out.append(0xCB)
            out.extend(struct.pack(">d", float(o)))
        elif isinstance(o, (int, np.integer)):
            o = int(o)
            if 0 <= o < 0x80:
                out.append(o)
            elif -32 <= o < 0:
                out.append(o & 0xFF)
            elif o >= 0:
                for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                      (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                    if o < top:
                        out.append(tag)
                        out.extend(struct.pack(fmt, o))
                        break
                else:
                    raise OverflowError(f"int {o} does not fit msgpack")
            else:
                for tag, fmt, bottom in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                                         (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
                    if o >= bottom:
                        out.append(tag)
                        out.extend(struct.pack(fmt, o))
                        break
                else:
                    raise OverflowError(f"int {o} does not fit msgpack")
        elif isinstance(o, str):
            b = o.encode("utf-8")
            n = len(b)
            if n < 32:
                out.append(0xA0 | n)
            elif n < 1 << 8:
                out.extend((0xD9, n))
            elif n < 1 << 16:
                out.append(0xDA)
                out.extend(struct.pack(">H", n))
            else:
                out.append(0xDB)
                out.extend(struct.pack(">I", n))
            out.extend(b)
        elif isinstance(o, (list, tuple)):
            _header(out, len(o), 0x90, 0xDC, 0xDD)
            for x in o:
                rec(x)
        elif isinstance(o, dict):
            _header(out, len(o), 0x80, 0xDE, 0xDF)
            for k, v in o.items():
                rec(k)
                rec(v)
        else:
            raise TypeError(f"cannot pack {type(o).__name__}")

    rec(obj)
    return bytes(out)


def _header(out: bytearray, n: int, fix: int, tag16: int, tag32: int) -> None:
    if n < 16:
        out.append(fix | n)
    elif n < 1 << 16:
        out.append(tag16)
        out.extend(struct.pack(">H", n))
    else:
        out.append(tag32)
        out.extend(struct.pack(">I", n))


_SCALARS = {0xC0: None, 0xC2: False, 0xC3: True}
_INTS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
         0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for what :func:`packb` writes (maps with
    str keys, lists, strings, ints, floats, None, bools); ``ValueError`` on
    anything else, on truncation and on trailing bytes."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated msgpack data")
        b = data[pos: pos + n]
        pos += n
        return b

    def rec():
        t = take(1)[0]
        if t < 0x80:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0xA0 <= t <= 0xBF:
            return take(t & 0x1F).decode("utf-8")
        if 0x90 <= t <= 0x9F:
            return [rec() for _ in range(t & 0x0F)]
        if 0x80 <= t <= 0x8F:
            return rmap(t & 0x0F)
        if t in _SCALARS:
            return _SCALARS[t]
        if t == 0xCB:
            return struct.unpack(">d", take(8))[0]
        if t in _INTS:
            fmt = _INTS[t]
            return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]
        if t in (0xD9, 0xDA, 0xDB):
            n = struct.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[t],
                              take({0xD9: 1, 0xDA: 2, 0xDB: 4}[t]))[0]
            return take(n).decode("utf-8")
        if t in (0xDC, 0xDD):
            n = struct.unpack(">H" if t == 0xDC else ">I", take(2 if t == 0xDC else 4))[0]
            return [rec() for _ in range(n)]
        if t in (0xDE, 0xDF):
            n = struct.unpack(">H" if t == 0xDE else ">I", take(2 if t == 0xDE else 4))[0]
            return rmap(n)
        raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")

    def rmap(n):
        out = {}
        for _ in range(n):
            k = rec()
            if not isinstance(k, str):
                raise ValueError(f"map key {k!r} is not a string")
            out[k] = rec()
        return out

    try:
        obj = rec()
    except UnicodeDecodeError as e:
        raise ValueError(f"bad msgpack string: {e}") from e
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after msgpack data")
    return obj


# ---------------------------------------------------------------------------
# Trees: the reference's leaf paths and treedef strings
# ---------------------------------------------------------------------------


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """``(kind, [(path key, child), ...])`` of a container, None for a leaf."""
    from repro_torch.core.exchange import ExchangeState

    if isinstance(node, dict):
        return "dict", [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return "namedtuple", [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return type(node).__name__, [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, ExchangeState):
        return "custom", [(str(i), getattr(node, f)) for i, f in enumerate(
            ("levels", "levels_lo", "hist", "step", "error", "pending"))]
    return None


def _flatten_with_paths(tree) -> dict:
    """``{path: leaf}`` in flatten order, paths as the reference writes
    them."""
    out: dict = {}
    _paths(tree, [], out)
    return out


def _paths(node, prefix: list, out: dict) -> None:
    # module-level recursion: a nested recursive closure would form a
    # reference cycle holding ``out`` (the leaves) until the cyclic gc
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out["/".join(prefix)] = node
        return
    for key, child in kids[1]:
        _paths(child, prefix + [key], out)


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` of the reference's
    counterpart of ``tree``."""

    def rec(node):
        if node is None:
            return "None"
        kids = _children(node)
        if kids is None:
            return "*"
        kind, items = kids
        inner = ", ".join(rec(c) for _, c in items)
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {rec(c)}" for k, c in items) + "}"
        if kind == "namedtuple":
            return f"CustomNode(namedtuple[{type(node).__name__}], [{inner}])"
        if kind == "custom":
            return f"CustomNode({type(node).__name__}[None], [{inner}])"
        if kind == "list":
            return f"[{inner}]"
        return f"({inner},)" if len(items) == 1 else f"({inner})"

    return f"PyTreeDef({rec(tree)})"


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, np.ndarray):
        return "int32"
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> list:
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, np.ndarray):
        return []
    return [int(d) for d in leaf.shape]


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the reference saves (bf16: its 2-byte
    void array)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, np.ndarray):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _from_host(arr: np.ndarray, template, dtype: str):
    """A loaded array as the template's kind of leaf: an int, a numpy
    array, or a torch tensor on the template's device."""
    if isinstance(template, (int, np.integer)) and not isinstance(template, np.ndarray):
        return int(arr)
    if not isinstance(template, torch.Tensor):
        return np.array(arr)
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(template.device)


def _rebuild(template, leaves_by_path: dict, prefix: tuple = ()):
    """``template``'s structure with the leaves of ``leaves_by_path`` (a
    plain recursion, so that no reference cycle holds the leaves)."""
    if template is None:
        return None
    kids = _children(template)
    if kids is None:
        return leaves_by_path["/".join(prefix)]
    kind, items = kids
    vals = [_rebuild(c, leaves_by_path, prefix + (k,)) for k, c in items]
    if kind == "dict":
        return dict(zip(sorted(template), vals))
    if kind in ("namedtuple", "custom"):
        return type(template)(*vals)
    return type(template)(vals)


# ---------------------------------------------------------------------------
# Save / restore
# ---------------------------------------------------------------------------


def _atomic_write(path: str, payload: bytes) -> None:
    """Write-then-rename: readers never observe a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path: str, step: int, trees: dict[str, Any], extra: dict | None = None) -> dict:
    """Save named trees (e.g. ``{'params': ..., 'opt_state': ...,
    'ex_state': ...}``): npz, then meta (with a crc32 per array), then the
    ``latest`` pointer.  Returns ``{"bytes": npz + meta size}``."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    meta: dict[str, Any] = {"step": step, "trees": {}, "extra": extra or {}}
    for name, tree in trees.items():
        flat = _flatten_with_paths(tree)
        keys = sorted(flat)
        host = {k: _to_host(flat[k]) for k in keys}
        meta["trees"][name] = {
            "keys": keys,
            "dtypes": {k: _dtype_name(flat[k]) for k in keys},
            "shapes": {k: list(host[k].shape) for k in keys},
            "crc32": {k: zlib.crc32(np.ascontiguousarray(host[k]).tobytes()) for k in keys},
            "treedef": treedef_str(tree),
        }
        for k in keys:
            arrays[f"{name}::{k}"] = host[k]
    npz_path = os.path.join(path, f"ckpt_{step}.npz")
    tmp = npz_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, npz_path)
    meta_bytes = packb(meta)
    _atomic_write(os.path.join(path, f"ckpt_{step}.meta"), meta_bytes)
    _atomic_write(os.path.join(path, "latest"), str(step).encode())
    return {"bytes": os.path.getsize(npz_path) + len(meta_bytes)}


def latest_step(path: str) -> int | None:
    """Step named by the ``latest`` pointer; None when it is missing,
    empty or garbage."""
    p = os.path.join(path, "latest")
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            text = f.read().strip()
        return int(text) if text else None
    except (ValueError, OSError, UnicodeDecodeError):
        return None


def available_steps(path: str) -> list[int]:
    """Steps with both payload and meta on disk, ascending."""
    if not os.path.isdir(path):
        return []
    steps = []
    for fn in os.listdir(path):
        if fn.startswith("ckpt_") and fn.endswith(".meta"):
            try:
                s = int(fn[len("ckpt_"):-len(".meta")])
            except ValueError:
                continue
            if os.path.exists(os.path.join(path, f"ckpt_{s}.npz")):
                steps.append(s)
    return sorted(steps)


def read_meta(path: str, step: int) -> dict:
    """The meta of ``step``; CheckpointCorruptError when missing or
    undecodable."""
    p = os.path.join(path, f"ckpt_{step}.meta")
    try:
        with open(p, "rb") as f:
            return unpackb(f.read())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(f"unreadable meta {p}: {e}") from e


def template_mismatch(meta: dict, name: str, template) -> str | None:
    """Why ``template`` cannot be restored from tree ``name`` of ``meta``
    (None = compatible): the missing tree, the differing keys, or the
    first shape / dtype conflict."""
    if name not in meta.get("trees", {}):
        return f"tree {name!r} not in checkpoint (has {sorted(meta['trees'])})"
    saved = meta["trees"][name]
    flat = _flatten_with_paths(template)
    keys = sorted(flat)
    if keys != saved["keys"]:
        diff = sorted(set(keys) ^ set(saved["keys"]))
        return f"leaf keys differ: {diff[:6]}{'...' if len(diff) > 6 else ''}"
    shapes = saved.get("shapes")
    dtypes = saved.get("dtypes", {})
    for k in keys:
        shape = _shape(flat[k])
        if shapes is not None and shape != list(shapes[k]):
            return f"leaf {k!r} shape {tuple(shapes[k])} != template {tuple(shape)}"
        if k in dtypes and _dtype_name(flat[k]) != dtypes[k]:
            return f"leaf {k!r} dtype {dtypes[k]} != template {_dtype_name(flat[k])}"
    return None


def _load_arrays(path: str, step: int):
    p = os.path.join(path, f"ckpt_{step}.npz")
    try:
        return np.load(p)
    except (OSError, ValueError, zlib.error, zipfile.BadZipFile, EOFError) as e:
        raise CheckpointCorruptError(f"unreadable npz {p}: {e}") from e


def restore(path: str, templates: dict[str, Any], step: int | None = None):
    """Restore into the structure of ``templates`` (same named trees):
    returns ``(step, {name: tree})``, each leaf of the template's kind
    (tensors on the template leaf's device).  Raises
    :class:`CheckpointStructureError` on a key / shape / dtype mismatch
    (never a silent cast) and :class:`CheckpointCorruptError` on
    unreadable or crc-mismatched files."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise CheckpointCorruptError(f"no usable 'latest' pointer at {path}")
    meta = read_meta(path, step)
    out = {}
    with _load_arrays(path, step) as data:
        for name, template in templates.items():
            mismatch = template_mismatch(meta, name, template)
            if mismatch is not None:
                raise CheckpointStructureError(name, mismatch)
            crcs = meta["trees"][name].get("crc32")
            dtypes = meta["trees"][name].get("dtypes", {})
            leaves = {}
            for pth, leaf in _flatten_with_paths(template).items():
                try:
                    arr = data[f"{name}::{pth}"]
                except (KeyError, OSError, ValueError, zlib.error,
                        zipfile.BadZipFile, EOFError) as e:
                    raise CheckpointCorruptError(
                        f"array {name}::{pth} unreadable in ckpt_{step}.npz: {e}") from e
                if crcs is not None:
                    got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                    if got != crcs[pth]:
                        raise CheckpointCorruptError(
                            f"crc mismatch for {name}::{pth} in ckpt_{step}.npz "
                            f"(stored {crcs[pth]}, computed {got})")
                want = _dtype_name(leaf)
                saved = dtypes.get(pth, str(arr.dtype))
                if list(arr.shape) != _shape(leaf):
                    raise CheckpointStructureError(
                        name, f"leaf {pth!r} shape {arr.shape} != template "
                              f"{tuple(_shape(leaf))}")
                stored = arr.dtype.itemsize == 2 if want == "bfloat16" else str(arr.dtype) == want
                if saved != want or not stored:
                    raise CheckpointStructureError(
                        name, f"leaf {pth!r} dtype {arr.dtype} != template {want} "
                              f"(refusing to cast)")
                leaves[pth] = _from_host(arr, leaf, want)
            out[name] = _rebuild(template, leaves)
    return step, out


def restore_with_fallback(path: str, templates: dict[str, Any], allow_reset: tuple = (),
                          max_retries: int = 3):
    """Restore the newest intact checkpoint, walking back past corrupt
    ones: the ``latest`` pointer's step first, then every on-disk step
    descending, at most ``max_retries`` candidates.  Structure mismatches
    do not walk back, except for tree names in ``allow_reset``, which are
    dropped from the restore and reported (the caller keeps their fresh
    state).  Returns ``(step, {name: tree}, reset names)``."""
    candidates: list[int] = []
    lat = latest_step(path)
    if lat is not None:
        candidates.append(lat)
    for s in sorted(available_steps(path), reverse=True):
        if s not in candidates:
            candidates.append(s)
    if not candidates:
        raise CheckpointCorruptError(f"no checkpoints found at {path}")
    last_err: CheckpointError | None = None
    for _attempt, step in retry_mod.attempts(candidates, max_retries):
        live = dict(templates)
        reset: list[str] = []
        try:
            meta = read_meta(path, step)
            for name in list(live):
                mismatch = template_mismatch(meta, name, live[name])
                if mismatch is not None:
                    if name in allow_reset:
                        reset.append(name)
                        del live[name]
                    else:
                        raise CheckpointStructureError(name, mismatch)
            got_step, trees = restore(path, live, step=step)
            return got_step, trees, tuple(reset)
        except CheckpointCorruptError as e:
            last_err = e
            continue
    raise CheckpointCorruptError(
        f"no intact checkpoint among {candidates[:max_retries]} at {path}: {last_err}")
