"""FRI's Poseidon-BN254 hash chains: every leaf sponge and Merkle climb of a
verification, as one plan of chain kinds.

Counterpart of the two ``lax.scan`` loops of ``plonky2_tpu/fri/verify.py``
(``_hash_leaves_scan`` at :101 and ``_merkle_chain`` at :68), which hash a
query round's leaves and climb from each leaf digest to a cap entry.  A
chain is one (proof, query round, kind); a kind is an initial oracle's tree
or a reduction step's tree.  A chain absorbs its leaf's blocks (HashNoPad:
slot 0 kept, the masked slots 1..3 replaced by the block; none for a
HashOrNoop oracle, whose packed leaf is its digest), then climbs its tree
(the sibling ordered by one bit of the query index, permute [0, 0, left,
right]); its root is element 0 of its last state.

``merkle_plan`` describes the kinds once per circuit, and ``slot_plan``
orders them, or packs them into lane slots that run several kinds back to
back, for the chain kernels' launch (``kernels/fri_merkle
.launch_geometry``).  ``merkle_roots`` gives every chain's root: on a CUDA
tensor one launch of the chain kernel of the selected permutation form
(``kernels/fri_merkle``, ``hash/poseidon_bn254.kernel_impl``), on a CPU
tensor ``merkle_roots_plain``, which runs every chain time-step-major in
plain torch: at step t one ``permute_plain`` over every chain still
running.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..fields import goldilocks as gl
from ..hash import poseidon_bn254 as pb
from ..proof.serde import absorb_slot_masks, leaf_layout


@dataclasses.dataclass(frozen=True)
class ChainKind:
    """One kind of chain over a batch's (B, Q) lanes.

    ``leaf_key`` names the leaf blocks in the tensor dict, (B, Q, T, 3, 16)
    (an initial oracle's at index ``oracle`` of axis 2 of
    ``init_leaf_packed``); ``steps`` absorb steps (0 for HashOrNoop), whose
    ``mask`` has bit 3 t + s set where step t absorbs slot s; ``sib_key``
    the siblings, (B, Q, depth, 16) (an oracle's at ``oracle`` of axis 2);
    level l reads bit ``offset + l`` of the query index."""
    name: str
    leaf_key: str
    oracle: int | None
    steps: int
    mask: int
    sib_key: str
    depth: int
    offset: int

    @property
    def length(self):
        """Permutations a chain of this kind runs."""
        return self.steps + self.depth

    def slot_mask(self):
        """The mask as (steps, 3) bool."""
        bits = [(self.mask >> i) & 1 for i in range(3 * self.steps)]
        return np.asarray(bits, dtype=bool).reshape(self.steps, 3)

    def leaves(self, dev):
        """The kind's leaf blocks in ``dev``, a (B, Q, max(steps, 1), 3, 16)
        view."""
        t = dev[self.leaf_key]
        if self.oracle is not None:
            t = t[:, :, self.oracle]
        return t[:, :, :max(self.steps, 1)]

    def siblings(self, dev):
        """The kind's siblings in ``dev``, a (B, Q, depth, 16) view."""
        t = dev[self.sib_key]
        return t if self.oracle is None else t[:, :, self.oracle]


def _mask_bits(slot_mask):
    return sum(1 << i for i, v in enumerate(np.asarray(slot_mask).reshape(-1))
               if v)


@functools.lru_cache(maxsize=16)
def merkle_plan(spec):
    """The chain kinds of a verification of ``spec``: the four initial
    oracles' trees (roots 0..3, depth ``initial_tree_depth``, from bit 0 of
    the query index), then each reduction step's tree (root 4 + j, from bit
    sum(arity_bits[:j + 1]): a step climbs on its coset's bits).  Every
    query window of the circuit (``fri.verify.query_rounds``) has the same
    plan: a window only sets how many rounds a batch's lanes hold."""
    layout = leaf_layout(spec)
    kinds = []
    for o in range(4):
        steps = 0 if layout.noop[o] else layout.n_steps[o]
        kinds.append(ChainKind(
            f"oracle{o}", "init_leaf_packed", o, steps,
            _mask_bits(layout.slot_mask[o, :steps]), "init_siblings",
            spec.initial_tree_depth, 0))
    offset = 0
    for j, arity_bits in enumerate(spec.reduction_arity_bits):
        offset += arity_bits
        mask = absorb_slot_masks((1 << arity_bits) * 2)
        kinds.append(ChainKind(
            f"step{j}", f"step{j}_leaf_packed", None, mask.shape[0],
            _mask_bits(mask), f"step{j}_siblings", spec.step_tree_depths[j],
            offset))
    return tuple(kinds)


def slot_plan(plan, pack=False):
    """Slot types over the plan: a tuple of tuples of indices into
    ``plan``, longest first (ties in plan order).  A lane slot of type
    ``(k0, k1, ...)`` runs its lane's chain of kind k0, then its chain of
    kind k1, ..., back to back.  Without ``pack`` each kind is a type of
    its own.  With it the kinds are packed first fit, longest first, into
    types whose lengths add up to at most the longest kind's: on step
    [oracle1], [oracle0], [oracle2, step0], [oracle3, step1] (28, 22, 27
    and 22 permutations; 88 % of the 4 x 28 slot steps busy, against 59 %
    of 6 x 28).  A pure function of its arguments."""
    order = sorted(range(len(plan)), key=lambda k: -plan[k].length)
    if not pack:
        return tuple((k,) for k in order)
    cap = plan[order[0]].length if order else 0
    bins = []
    for k in order:
        for b in bins:
            if slot_length(plan, b) + plan[k].length <= cap:
                b.append(k)
                break
        else:
            bins.append([k])
    return tuple(tuple(b) for b in bins)


def slot_length(plan, kinds):
    """Permutations a lane slot of the type ``kinds`` runs."""
    return sum(plan[k].length for k in kinds)


def _bit(x_index, bit):
    """Bit ``bit`` of the query index, a GL pair of 32-bit words, as bool."""
    return ((x_index[bit >> 5] >> (bit & 31)) & 1).bool()


def _step_input(kind, state, t, dev, x_index, mask):
    """The state chain ``kind`` permutes at its step t: its absorb of block t
    (slot 0 kept, the masked slots replaced), else its level t - steps
    ([0, 0, left, right] around its digest, state element 0)."""
    if t < kind.steps:
        rest = torch.where(mask[t][:, None], kind.leaves(dev)[:, :, t],
                           state[..., 1:, :])
        return torch.cat([state[..., :1, :], rest], dim=-2)
    level = t - kind.steps
    cur = state[..., 0, :]
    sib = kind.siblings(dev)[:, :, level]
    m = _bit(x_index, kind.offset + level)[..., None]
    z = torch.zeros_like(cur)
    return torch.stack([z, z, torch.where(m, sib, cur),
                        torch.where(m, cur, sib)], dim=-2)


def merkle_roots_plain(plan, dev, x_index):
    """Plain torch: every chain's root, (B, Q, len(plan), 16) canonical
    Montgomery limbs, root k of chain kind ``plan[k]``.  ``dev``: the
    tensor dict; ``x_index``: the query indices, a GL pair (B, Q).  Step t
    is one ``permute_plain`` over every chain still running, the schedule
    the kernels run; each chain computes what ``fri.verify
    ._hash_leaves_scan`` then ``_merkle_chain`` compute."""
    B, Q = x_index[0].shape
    device = x_index[0].device
    states = []
    for kind in plan:
        st = torch.zeros((B, Q, pb.WIDTH, 16), dtype=torch.int64, device=device)
        if kind.steps == 0:  # HashOrNoop: the packed leaf is the digest
            st[..., 0, :] = kind.leaves(dev)[:, :, 0, 0]
        states.append(st)
    masks = [gl.device_table(kind.slot_mask(), device) for kind in plan]
    for t in range(max(kind.length for kind in plan)):
        running = [k for k, kind in enumerate(plan) if t < kind.length]
        ins = torch.stack([_step_input(plan[k], states[k], t, dev, x_index,
                                       masks[k]) for k in running], dim=2)
        for k, st in zip(running, pb.permute_plain(ins).unbind(2)):
            states[k] = st
    return torch.stack([st[..., 0, :] for st in states], dim=2)



def merkle_roots(plan, dev, x_index):
    """Every chain's root, as ``merkle_roots_plain``: on a CUDA tensor one
    launch of the chain kernel of ``pb.kernel_impl()``'s form (kernel A's
    under ``mxu``, the CIOS form's under ``cios``), which raises if it
    cannot; the plain version only on a CPU tensor."""
    if x_index[0].device.type == "cpu":
        return merkle_roots_plain(plan, dev, x_index)
    from ..kernels import fri_merkle as kf
    kernel = kf.chains_cios if pb.kernel_impl() == "cios" else kf.chains_a
    return kernel(plan, dev, x_index)
