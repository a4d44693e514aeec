"""Plumbing tests (reference test-utils.R, test-divide-batches.R, test-tree.R)."""
import numpy as np
import pytest

from batchelor_tpu.utils.batching import (
    combine_restrict,
    divide_into_batches,
    reindex_pairings,
    restore_original_order,
    subset_to_index,
    intersect_rows,
)
from batchelor_tpu.utils.trees import (
    binarize_tree,
    create_tree_predefined,
    get_next_merge,
    tree_weights,
    update_tree,
    MergeNode,
)


def test_divide_and_reorder(rng):
    x = rng.normal(size=(100, 10))
    batch = rng.integers(0, 3, size=100)
    out = divide_into_batches(x, batch, cells_in_rows=True)
    combined = np.concatenate(out.batches, axis=0)
    assert np.array_equal(combined[out.reorder], x)
    assert out.names == [0, 1, 2]


def test_divide_restrict(rng):
    x = rng.normal(size=(50, 4))
    batch = np.repeat([0, 1], 25)
    res = np.arange(0, 50, 2)
    out = divide_into_batches(x, batch, restrict=res)
    assert np.array_equal(out.restricted[0], np.arange(0, 25, 2))
    assert np.array_equal(out.restricted[1], np.arange(1, 25, 2))
    with pytest.raises(ValueError):
        divide_into_batches(x, batch, restrict=np.array([0, 2, 4]))  # none in batch 1


def test_restore_original_order():
    # 3 batches of sizes 2,3,4 merged in order [2,0,1]
    order = [2, 0, 1]
    ncells = [2, 3, 4]
    perm = restore_original_order(order, ncells)
    merged_origin = np.repeat(order, [ncells[i] for i in order])
    assert np.array_equal(merged_origin[perm], np.repeat([0, 1, 2], ncells))


def test_reindex_pairings():
    new_order = np.array([3, 0, 1, 2])
    pairs = [np.array([[3, 0], [1, 2]])]
    out = reindex_pairings(pairs, new_order)
    # cell formerly at merged position 3 is output row 0, etc.
    assert np.array_equal(out[0], np.array([[0, 1], [2, 3]]))


def test_subset_to_index():
    assert np.array_equal(subset_to_index(None, 4), np.arange(4))
    assert np.array_equal(subset_to_index([True, False, True], 3), [0, 2])
    assert np.array_equal(subset_to_index(["b", "a"], 2, ["a", "b"]), [1, 0])
    with pytest.raises(ValueError):
        subset_to_index([5], 3)


def test_combine_restrict():
    assert combine_restrict(3, None, 2, None) is None
    out = combine_restrict(3, np.array([1]), 2, None)
    assert np.array_equal(out, [1, 3, 4])


def test_intersect_rows(rng):
    a = rng.normal(size=(5, 4))
    b = rng.normal(size=(5, 3))
    names_a = ["g1", "g2", "g3", "g4"]
    names_b = ["g4", "g2", "g9"]
    out, names = intersect_rows([a, b], [names_a, names_b])
    assert names == ["g2", "g4"]
    assert np.array_equal(out[0], a[:, [1, 3]])
    assert np.array_equal(out[1], b[:, [1, 0]])


def test_binarize_tree():
    # progressive merge of >2 children (reference test-tree.R:4-30)
    assert binarize_tree([1, 2, 3]) == [[1, 2], 3]
    assert binarize_tree([[1], [2, 3, 4]]) == [1, [[2, 3], 4]]
    with pytest.raises(ValueError):
        binarize_tree([])


def test_merge_tree_walk(rng):
    batches = [rng.normal(size=(5 + i, 3)) for i in range(4)]
    tree = create_tree_predefined(batches, None, [[0, 1], [2, 3]])
    left, right, path = get_next_merge(tree)
    assert left.index == [2] and right.index == [3]
    merged = MergeNode(
        index=[2, 3],
        data=np.concatenate([left.data, right.data]),
        restrict=None,
        origin=np.concatenate([left.origin, right.origin]),
    )
    tree = update_tree(tree, path, merged)
    left, right, path = get_next_merge(tree)
    assert left.index == [0] and right.index == [1]


def test_merge_tree_linear_order(rng):
    batches = [rng.normal(size=(4, 2)) for _ in range(3)]
    tree = create_tree_predefined(batches, None, [2, 0, 1])
    left, right, _ = get_next_merge(tree)
    assert left.index == [2] and right.index == [0]


def test_merge_tree_names(rng):
    batches = [rng.normal(size=(4, 2)) for _ in range(2)]
    tree = create_tree_predefined(batches, None, ["b", "a"], names=["a", "b"])
    left, right, _ = get_next_merge(tree)
    assert left.index == [1] and right.index == [0]
    with pytest.raises(ValueError):
        create_tree_predefined(batches, None, [0, 0])


def test_tree_weights():
    w = tree_weights([0, [1, 2]], 3)
    assert np.allclose(w, [0.5, 0.25, 0.25])
    w = tree_weights([[0, 1], [2, 3]], 4)
    assert np.allclose(w, [0.25] * 4)
    with pytest.raises(ValueError):
        tree_weights([0, [1, 1]], 3)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper returns it and leaves
    JAX's own setting alone."""
    import jax

    from batchelor_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    """Unset, the cache is the fixed <repo>/.jax_cache."""
    import os

    import jax

    from batchelor_tpu.utils import cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.use_compile_cache() == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == cache.REPO_CACHE_DIR
