"""ZeRO-1-style sharded-table optimizer partitioning.

The data-parallel step (train/loop.py:make_train_step) replicates every
parameter and psums the full gradient, so per-TABLE work — Adam moments,
weight decay, the update itself — replicates across the mesh.  For the
table-dominated fields (K-Planes: 33.2M of 33.23M params are plane tables;
cobafa: the basis/coef grids) that replicated slice is table-sized work
that does not divide by the mesh.

This module implements the standard remedy with XLA collectives (no
reference counterpart — the reference is single-GPU, SURVEY.md §5):

  - gradients for table leaves are `psum_scatter`'d instead of psum'd:
    each device receives the SUM of a 1/N slice of the flattened table
    gradient (half the bytes of a psum, since no broadcast back);
  - the optimizer state (Adam mu/nu) for table leaves lives sharded —
    each device materializes and updates only its slice (memory and
    optimizer FLOPs divide by N);
  - updated table slices are `all_gather`'d back into full (replicated)
    tables for the next forward (same bytes as the psum broadcast
    half, so total comm per step is unchanged vs plain DP).

Table membership is DECLARED by the field (`field.table_keys`, the same
declaration the weight-decay mask uses) — never inferred from shapes.

The flattened-view convention: a table leaf of shape S with L = prod(S)
elements is viewed as a zero-padded flat f32 vector of length
Lp = ceil(L / n_shards) * n_shards.  OUTSIDE shard_map the "global view"
holds the full [Lp]; INSIDE shard_map the local view holds this device's
[Lp / n_shards] slice.  Zero padding is a fixed point of Adam + weight
decay (grad 0, param 0 -> update 0), so pads never contaminate values.
"""

from __future__ import annotations

import math
from functools import partial
from typing import FrozenSet

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .mesh import DATA_AXIS


def _path_is_table(path, table_keys: FrozenSet[str]) -> bool:
    """True iff this leaf path addresses a declared feature table.

    Works on the param tree AND any tree that embeds the param tree under a
    prefix (optax states: mu/nu mirror params), by looking for a "field"
    path component followed somewhere by a declared table key."""
    keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
    if "field" not in keys:
        return False
    i = keys.index("field")
    return any(k in table_keys for k in keys[i + 1 :])


def table_mask_tree(tree, table_keys: FrozenSet[str]):
    """Pytree of bools over `tree`: True = sharded table leaf."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: _path_is_table(path, table_keys), tree
    )


def spec_tree(tree, table_keys: FrozenSet[str]):
    """shard_map in/out specs for a (viewed) tree: table-derived leaves are
    sharded on the data axis, everything else replicated.  Applies to the
    global param/grad VIEW and to optax states built from it."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: P(DATA_AXIS) if _path_is_table(path, table_keys) else P(),
        tree,
    )


def _padded_len(n: int, shards: int) -> int:
    return math.ceil(n / shards) * shards


def global_view(tree, table_keys: FrozenSet[str], n_shards: int):
    """Replace each table leaf [S] by its zero-padded flat [Lp] form.

    Tree STRUCTURE is preserved (leaves swap shape only), so optax masks
    computed by path — the weight-decay mask, the split-lr table mask —
    see the identical structure and classify identically."""

    def go(path, leaf):
        if not _path_is_table(path, table_keys):
            return leaf
        flat = leaf.reshape(-1)
        lp = _padded_len(flat.shape[0], n_shards)
        return jnp.pad(flat, (0, lp - flat.shape[0]))

    return jax.tree_util.tree_map_with_path(go, tree)


def local_view(tree, table_keys: FrozenSet[str], n_shards: int, shard_idx):
    """INSIDE shard_map: this device's [Lp/n] slice of each table leaf
    (from the full replicated leaf), other leaves untouched."""

    def go(path, leaf):
        if not _path_is_table(path, table_keys):
            return leaf
        flat = leaf.reshape(-1)
        lp = _padded_len(flat.shape[0], n_shards)
        flat = jnp.pad(flat, (0, lp - flat.shape[0]))
        l = lp // n_shards
        return jax.lax.dynamic_slice(flat, (shard_idx * l,), (l,))

    return jax.tree_util.tree_map_with_path(go, tree)


def reduce_grads(grads, table_keys: FrozenSet[str], n_shards: int):
    """INSIDE shard_map: psum non-table grads; psum_scatter table grads to
    this device's flat slice (the local grad view)."""

    def go(path, g):
        if not _path_is_table(path, table_keys):
            return jax.lax.psum(g, DATA_AXIS)
        flat = g.reshape(-1)
        lp = _padded_len(flat.shape[0], n_shards)
        flat = jnp.pad(flat, (0, lp - flat.shape[0]))
        return jax.lax.psum_scatter(
            flat, DATA_AXIS, scatter_dimension=0, tiled=True
        )

    return jax.tree_util.tree_map_with_path(go, grads)


def unview(view_tree, like_tree, table_keys: FrozenSet[str]):
    """INSIDE shard_map: all_gather each local table slice back to the full
    leaf shape of `like_tree`; other leaves pass through."""

    def go(path, v, like):
        if not _path_is_table(path, table_keys):
            return v
        full = jax.lax.all_gather(v, DATA_AXIS, tiled=True)
        n = int(math.prod(like.shape))
        return full[:n].reshape(like.shape)

    return jax.tree_util.tree_map_with_path(go, view_tree, like_tree)


def has_tables(params, table_keys: FrozenSet[str]) -> bool:
    return any(
        jax.tree_util.tree_leaves(table_mask_tree(params, table_keys))
    )


def sharded_opt_init(optimizer, params, table_keys: FrozenSet[str], n_shards: int):
    """Initial optimizer state over the GLOBAL view (table moment leaves are
    full [Lp] flats; shard_map in_specs from `spec_tree` split them)."""
    view = global_view(params, table_keys, n_shards)
    return jax.jit(partial(_opt_init, optimizer))(view)


def _opt_init(optimizer, view):
    return optimizer.init(view)
