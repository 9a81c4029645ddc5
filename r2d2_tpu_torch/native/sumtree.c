/* Native hot loops for the prioritised-replay sum tree.
 *
 * The host side of the framework (SURVEY §2.1 #8: the reference's
 * PriorityTree, priority_tree.py:4-45) is pointer-chasing over a flat
 * binary-heap array — the wrong shape for an accelerator *and* an awkward shape
 * for numpy: the vectorised Python implementation (replay/sum_tree.py)
 * spends its time in per-level `np.unique` + fancy-indexing dispatch
 * overhead rather than arithmetic.  On the training host this code shares
 * one core with actor inference and the interconnect relay, so shaving
 * the tree ops to microseconds (and releasing the GIL while they run —
 * ctypes does that for free) buys real fabric throughput.
 *
 * Layout contract (must match r2d2_tpu_torch/replay/sum_tree.py): `nodes` is the flat
 * heap, node 0 the root, children of i at 2i+1 / 2i+2, leaves start at
 * `leaf_offset = 2**(levels-1) - 1`.  All functions are exact ports of
 * the numpy arithmetic — same operation order, bit-identical results —
 * so the Python oracle tests validate both paths.
 *
 * Build: compiled on demand by r2d2_tpu_torch/native/__init__.py (cc -O2
 * -shared -fPIC); loaded via ctypes.  No Python.h dependency.  A copy of
 * r2d2_tpu/native/sumtree.c: host C code, not a device kernel.
 */

#include <stdint.h>

/* Set leaves[idxes[i]] = prios[i] (already exponentiated by the caller)
 * and repair all ancestor sums level by level.  Duplicate parents are
 * recomputed idempotently — cheaper than dedup at batch sizes ~64. */
void st_update(double *nodes, int64_t num_levels, int64_t leaf_offset,
               const int64_t *idxes, const double *prios, int64_t n) {
    for (int64_t i = 0; i < n; ++i) {
        nodes[leaf_offset + idxes[i]] = prios[i];
    }
    /* walk each touched path upward; level-synchronous so a parent's
     * children are final before the parent is recomputed */
    /* small scratch on stack for typical n; fall back to in-place walking
     * of the caller's idx array is avoided to keep the API const */
    int64_t scratch[1024];
    int64_t *cur = scratch;
    if (n > 1024) {
        /* degenerate: walk one path at a time (still exact) */
        for (int64_t i = 0; i < n; ++i) {
            int64_t node = leaf_offset + idxes[i];
            while (node > 0) {
                node = (node - 1) / 2;
                nodes[node] = nodes[2 * node + 1] + nodes[2 * node + 2];
            }
        }
        return;
    }
    for (int64_t i = 0; i < n; ++i) cur[i] = leaf_offset + idxes[i];
    for (int64_t lvl = 0; lvl < num_levels - 1; ++lvl) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t p = (cur[i] - 1) / 2;
            nodes[p] = nodes[2 * p + 1] + nodes[2 * p + 2];
            cur[i] = p;
        }
    }
}

/* Vectorised lock-step top-down descent: prefix-sum targets -> leaf NODE
 * ids (same arithmetic as SumTree._descend: compare against the left
 * child's mass, subtract when going right). */
void st_descend(const double *nodes, int64_t num_levels,
                const double *targets_in, int64_t n, int64_t *out_nodes) {
    for (int64_t i = 0; i < n; ++i) {
        double t = targets_in[i];
        int64_t node = 0;
        for (int64_t lvl = 0; lvl < num_levels - 1; ++lvl) {
            int64_t left = 2 * node + 1;
            double lm = nodes[left];
            if (t >= lm) {
                node = left + 1;
                t -= lm;
            } else {
                node = left;
            }
        }
        out_nodes[i] = node;
    }
}

/* Total mass of leaves strictly before leaf_idx (root-walk, exact port of
 * SumTree.prefix_mass). */
double st_prefix_mass(const double *nodes, int64_t leaf_offset,
                      int64_t leaf_idx) {
    int64_t node = leaf_idx + leaf_offset;
    double mass = 0.0;
    while (node > 0) {
        int64_t parent = (node - 1) / 2;
        if (node == 2 * parent + 2) {
            mass += nodes[2 * parent + 1];
        }
        node = parent;
    }
    return mass;
}
