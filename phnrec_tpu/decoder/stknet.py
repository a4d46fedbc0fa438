"""Generic HMM-network Viterbi decoder over STK networks (dense lattice
scan) with keyword-spotting support.

The reference adapts STKLib's token-passing engine (stkinterface.{cpp,h} ->
STKLib/Viterbi.cc): per frame, tokens propagate inside active models
(TokenPropagationInModels, Viterbi.cc:1505-1719) and then across the
network through null/word nodes with word penalties and LM-scaled arc
likelihoods (TokenPropagationInNetwork, Viterbi.cc:1340-1500), recording
word passages as ref-counted WordLinkRecords.

Redesign: token passing over linked lists is hostile to XLA, but
the graphs phnrec exercises are small and static, so the network COMPILES
to dense arrays:

  * every emitting HMM state of every model node gets a global index;
    within-model transitions, entry (state 0 -> j) and exit (i -> N-1)
    rows become edge lists (src, dst, log-prob),
  * chains of instantaneous nodes (nulls and word nodes) are closed over
    at compile time: each path model-exit -> ... -> model-entry becomes
    one "closure edge" carrying the accumulated LM likes (* lm_scale),
    word penalties (Viterbi.cc:1405-1414: wPenalty + pronScale*pronprob
    per word node crossed) and the sequence of words passed,
  * the per-frame recursion is then three segment-max reductions inside a
    `lax.scan`, with argmax edge ids recorded for exact traceback.

Tie-breaking parity: PassTokenMax takes strictly-greater (Viterbi.cc:
1727-1752), so among equal-scoring edges the first processed wins; edges
are ordered by STK's document/processing order and ties resolve to the
lowest edge index.

Observation lookup: <PDFObsVec> states read obs[PDF_obs_coef]
(Viterbi.cc:760-768, the phnrec path); DiagC GMM states get their log
likelihood batch-precomputed as GEMMs before the scan.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from phnrec_tpu.io.labels import Label
from phnrec_tpu.io.mmf import LOG_0, ModelSet
from phnrec_tpu.io.stknet import NetNode, StkNetwork

NEG = np.float32(-1e30)
OFF_BEAM = np.float32(1e30)   # beam width that never prunes (default off)


# ---------------------------------------------------------------------------
# compilation
# ---------------------------------------------------------------------------
@dataclass
class ClosureEdge:
    src: int                 # source model index, or -1 for network START
    dst: int                 # destination model index, or -1 (sink)
    sink: Optional[int]      # sink index when dst == -1
    score: float             # sum of lm*scale + word penalties along path
    words: Tuple[str, ...]   # words crossed, in order
    word_time_reset: bool    # True iff words were crossed (WLR time = now)


@dataclass
class CompiledNetwork:
    # emitting states
    n_states: int
    n_models: int
    obs_index: np.ndarray          # [E] posterior column per state (-1 = GMM)
    gmm_index: np.ndarray          # [E] row into gmm loglik matrix (-1)
    state_model: np.ndarray        # [E] owning model index
    model_names: List[str]
    # within-model + entry edges (targets are emitting states)
    in_src: np.ndarray             # [Ein] source: emitting state id, or
    in_src_is_entry: np.ndarray    # [Ein] bool: src is the model entry slot
    in_dst: np.ndarray             # [Ein]
    in_w: np.ndarray               # [Ein]
    # exit edges (emitting state -> model exit slot)
    ex_src: np.ndarray             # [Eex]
    ex_dst_model: np.ndarray       # [Eex]
    ex_w: np.ndarray               # [Eex]
    # closure edges between models / start / sinks
    closure: List[ClosureEdge]
    # sinks (terminal node + KWS sticky ends)
    sink_names: List[Optional[str]]   # word name or None (null sink)
    terminal_sink: int
    kws_word_sinks: List[int]
    kws_filler_sink: Optional[int]
    gmm_states: List                  # GMMState list for batch eval


def compile_network(net: StkNetwork, models: ModelSet, wpenalty: float,
                    lm_scale: float, mpenalty: float = 0.0,
                    pron_scale: float = 1.0) -> CompiledNetwork:
    model_nodes = [n for n in net.nodes if n.is_model]
    model_index = {id(n): i for i, n in enumerate(model_nodes)}

    # ---- emitting state table
    obs_index: List[int] = []
    gmm_index: List[int] = []
    state_model: List[int] = []
    gmm_states: List = []
    in_src, in_entry, in_dst, in_w = [], [], [], []
    ex_src, ex_dst, ex_w = [], [], []
    state_base: List[int] = []
    for mi, node in enumerate(model_nodes):
        if node.model not in models.hmms:
            raise ValueError(f"model {node.model!r} not in HMM set")
        hmm = models.hmms[node.model]
        N = hmm.n_states
        base = len(obs_index)
        state_base.append(base)
        for j in range(N - 2):
            oc = hmm.obs_coefs[j]
            if oc is not None:
                obs_index.append(oc)
                gmm_index.append(-1)
            else:
                obs_index.append(-1)
                gmm_index.append(len(gmm_states))
                gmm_states.append(hmm.gmm_states[j])
            state_model.append(mi)
        lt = hmm.log_transp
        for j in range(1, N - 1):           # to emitting state j
            if lt[0, j] > LOG_0 / 2:        # entry edge
                in_src.append(mi)
                in_entry.append(True)
                in_dst.append(base + j - 1)
                in_w.append(float(lt[0, j]))
            for i in range(1, N - 1):       # from emitting state i
                if lt[i, j] > LOG_0 / 2:
                    in_src.append(base + i - 1)
                    in_entry.append(False)
                    in_dst.append(base + j - 1)
                    in_w.append(float(lt[i, j]))
        for i in range(1, N - 1):           # exit edges
            if lt[i, N - 1] > LOG_0 / 2:
                ex_src.append(base + i - 1)
                ex_dst.append(mi)
                ex_w.append(float(lt[i, N - 1]))

    # ---- sinks: terminal + sticky non-model nodes
    sink_nodes: List[NetNode] = []
    last = net.last
    if not last.is_model:
        sink_nodes.append(last)
    for n in net.nodes:
        if not n.is_model and n.is_sticky and n is not last:
            sink_nodes.append(n)
    sink_of = {id(n): i for i, n in enumerate(sink_nodes)}

    # ---- closure over instantaneous nodes (nulls, word nodes, and TEE
    # models — models with a direct entry->exit transition, Net.h:33-43,
    # passed through within a frame by Viterbi.cc:1340-1500).
    #
    # Only the BEST-scoring instantaneous path between a (source, target)
    # pair can ever win the runtime max, and closure scores are static,
    # so the walk is single-source max-plus relaxation with per-node
    # memoization and parent backpointers — O(V*E) worst case instead of
    # path enumeration (exponential on diamond null lattices, recursion-
    # depth-bound on deep chains).  Zero/negative-score cycles through
    # null nodes converge (relaxation is strict-improvement only);
    # positive cycles would let a token gain score within one frame and
    # raise, as STK would loop.
    #
    # Tie policy: among EQUAL-score instantaneous paths between the same
    # (source, target), the first-reached path in seed/BFS order wins.
    # This matches STK's strictly-greater token passing in spirit but is
    # not guaranteed to pick the same WORD SEQUENCE as STK's exact
    # active-list order for pathological networks where two equal-score
    # null paths carry different words (no generated phnrec network has
    # such ties; the oracle suites pin the real networks' behavior).
    closure: List[ClosureEdge] = []

    tee_weight: Dict[int, float] = {}
    for mi, node in enumerate(model_nodes):
        lt = models.hmms[node.model].log_transp
        if lt[0, lt.shape[0] - 1] > LOG_0 / 2:
            tee_weight[mi] = float(lt[0, lt.shape[0] - 1])

    node_doc_order = {id(n): i for i, n in enumerate(net.nodes)}

    def emit_closures(src_model: int, seeds) -> None:
        """seeds: [(target_node, arrival_score)] — arcs leaving the
        source with lm like already applied.  Relax to fixpoint, then
        emit one ClosureEdge per reached model entry / sink."""
        from collections import deque

        best: Dict[int, Tuple[float, Optional[int], Optional[str],
                              NetNode]] = {}
        # best[id] = (score, parent_id, word_emitted_at_node, node)
        relax = {}
        work = deque()
        limit = len(net.nodes) + 1

        def arrive(node: NetNode, score: float, parent: Optional[int]
                   ) -> None:
            word = None
            if not node.is_model and node.word is not None:
                score += wpenalty   # + pron_scale * pronprob (0 here)
                word = node.word
            cur = best.get(id(node))
            if cur is not None and score <= cur[0]:
                return              # strict improvement only: ties keep
            relax[id(node)] = relax.get(id(node), 0) + 1
            if relax[id(node)] > limit:
                raise ValueError(
                    "positive-score cycle through instantaneous nodes")
            best[id(node)] = (score, parent, word, node)
            work.append(node)

        for tgt, s in seeds:
            arrive(tgt, s, None)
        while work:
            node = work.popleft()
            score = best[id(node)][0]
            if node.is_model:
                # continue only THROUGH tee models (entry->exit within
                # the frame, + the model penalty applied on exit)
                tw = tee_weight.get(model_index[id(node)])
                if tw is None:
                    continue
                score = score + tw + mpenalty
            for tgt, arc_lm in node.links:
                arrive(tgt, score + arc_lm * lm_scale, id(node))

        def words_of(nid: int) -> Tuple[str, ...]:
            out: List[str] = []
            while nid is not None:
                score, parent, word, _ = best[nid]
                if word is not None:
                    out.append(word)
                nid = parent
            out.reverse()
            return tuple(out)

        # emit in document order of the target (the runtime dense-row
        # argmax resolves ties to the lowest edge id, matching STK's
        # document-order first-wins processing)
        for nid, (score, parent, word, node) in sorted(
                best.items(), key=lambda kv: node_doc_order[kv[0]]):
            words = words_of(nid)
            if node.is_model:
                closure.append(ClosureEdge(
                    src_model, model_index[id(node)], None, score,
                    words, bool(words)))
            elif nid in sink_of:
                # sticky sinks keep propagating within the frame:
                # StkInterface kills their tokens only AFTER the frame
                # (stkinterface.cpp:279); propagation continued above
                closure.append(ClosureEdge(
                    src_model, -1, sink_of[nid], score, words,
                    bool(words)))

    # from network START
    start = net.first
    if start.is_model:
        closure.append(ClosureEdge(-1, model_index[id(start)], None, 0.0,
                                   (), False))
    else:
        emit_closures(-1, [(start, 0.0)])
    # from each model's exit (model exit adds mMPenalty, Viterbi.cc:1406)
    for mi, node in enumerate(model_nodes):
        emit_closures(mi, [(tgt, mpenalty + arc_lm * lm_scale)
                           for tgt, arc_lm in node.links])

    kws_word_sinks = [i for i, n in enumerate(sink_nodes)
                      if n.is_sticky and n.word is not None]
    kws_filler = [i for i, n in enumerate(sink_nodes)
                  if n.is_sticky and n.word is None and n is not net.last]
    # the terminal may itself be the filler end (loop networks reuse it)
    if not kws_filler and sink_nodes and sink_nodes[0].word is None:
        kws_filler = [0]

    return CompiledNetwork(
        n_states=len(obs_index),
        n_models=len(model_nodes),
        obs_index=np.asarray(obs_index, np.int32),
        gmm_index=np.asarray(gmm_index, np.int32),
        state_model=np.asarray(state_model, np.int32),
        model_names=[n.model for n in model_nodes],
        in_src=np.asarray(in_src, np.int32),
        in_src_is_entry=np.asarray(in_entry, bool),
        in_dst=np.asarray(in_dst, np.int32),
        in_w=np.asarray(in_w, np.float32),
        ex_src=np.asarray(ex_src, np.int32),
        ex_dst_model=np.asarray(ex_dst, np.int32),
        ex_w=np.asarray(ex_w, np.float32),
        closure=closure,
        sink_names=[n.word for n in sink_nodes],
        terminal_sink=0 if sink_nodes else -1,
        kws_word_sinks=kws_word_sinks,
        kws_filler_sink=kws_filler[0] if kws_filler else None,
        gmm_states=gmm_states,
    )


# ---------------------------------------------------------------------------
# dense Viterbi scan
# ---------------------------------------------------------------------------
class NetworkDecoder:
    """Dense Viterbi over a compiled network."""

    def __init__(self, compiled: CompiledNetwork):
        self.c = c = compiled
        # split closure edges: model->model (graph edges) and ->sink
        self.cm = [e for e in c.closure if e.dst >= 0]
        self.cs = [e for e in c.closure if e.dst < 0]
        self.cm_src = jnp.asarray([e.src for e in self.cm], jnp.int32)
        self.cm_dst = jnp.asarray([e.dst for e in self.cm], jnp.int32)
        self.cm_w = jnp.asarray([e.score for e in self.cm], jnp.float32)
        self.cm_reset = jnp.asarray(
            [e.word_time_reset for e in self.cm], bool)
        self.cs_src = jnp.asarray([e.src for e in self.cs], jnp.int32)
        self.cs_sink = jnp.asarray([e.sink for e in self.cs], jnp.int32)
        self.cs_w = jnp.asarray([e.score for e in self.cs], jnp.float32)
        self.in_src = jnp.asarray(c.in_src)
        self.in_entry = jnp.asarray(c.in_src_is_entry)
        self.in_dst = jnp.asarray(c.in_dst)
        self.in_w = jnp.asarray(c.in_w)
        self.ex_src = jnp.asarray(c.ex_src)
        self.ex_dst = jnp.asarray(c.ex_dst_model)
        self.ex_w = jnp.asarray(c.ex_w)
        self.obs_idx = jnp.asarray(np.maximum(c.obs_index, 0))
        self.n_sinks = len(c.sink_names)
        # clipped source index views for the traceback gathers
        self.in_src_m_dev = self.in_src.clip(0, max(c.n_models - 1, 0))
        self.in_src_s_dev = self.in_src.clip(0, max(c.n_states - 1, 0))

        # Dense incoming-edge tables: for each destination, the edge ids
        # feeding it, ascending (row-padded with -1).  The per-frame
        # reductions become gather + max over a static K axis instead of
        # jax.ops.segment_max — segment reductions lower to scatters that
        # crawl under vmap (batched decode measured ~10x slower).
        # Ascending edge ids per row + argmax-first-match = the same
        # first-wins tie-breaking as PassTokenMax (Viterbi.cc:1727-1752).
        def dense_in(dst: np.ndarray, num: int) -> np.ndarray:
            rows = [[] for _ in range(num)]
            for k, d in enumerate(np.asarray(dst)):
                rows[int(d)].append(k)
            K = max((len(r) for r in rows), default=1) or 1
            out = np.full((num, K), -1, np.int64)
            for i, r in enumerate(rows):
                out[i, : len(r)] = r
            return out

        self.in_dense = jnp.asarray(dense_in(c.in_dst, c.n_states))
        self.ex_dense = jnp.asarray(dense_in(c.ex_dst_model, c.n_models))
        self.cm_dense = jnp.asarray(
            dense_in(np.asarray([e.dst for e in self.cm], np.int64),
                     c.n_models))
        self.cs_dense = jnp.asarray(
            dense_in(np.asarray([e.sink for e in self.cs], np.int64),
                     self.n_sinks)) if self.cs else None

    # -- initial entry values (ViterbiInit: token like 0 in first node,
    #    then one network propagation)
    def _init_entry(self):
        M = self.c.n_models
        entry = np.full(M, NEG, np.float32)
        entry_edge = np.full(M, -1, np.int32)
        entry_wt = np.zeros(M, np.int32)
        for k, e in enumerate(self.cm):
            if e.src == -1 and e.score > entry[e.dst]:
                entry[e.dst] = e.score
                entry_edge[e.dst] = k
        return entry, entry_edge, entry_wt

    def _gmm_groups(self):
        """Stack same-shape GMM states into [G, M, D] tensors, built once
        (cached): a 500-state DiagC network then scores in O(#shapes)
        fused einsum/logsumexp ops instead of one op chain per state."""
        cached = getattr(self, "_gmm_groups_cache", None)
        if cached is not None:
            return cached
        by_shape: Dict[Tuple[int, int], List[int]] = {}
        for gi, g in enumerate(self.c.gmm_states):
            by_shape.setdefault(g.means.shape, []).append(gi)
        groups = []
        for shape, idxs in by_shape.items():
            gs = [self.c.gmm_states[i] for i in idxs]
            means = np.stack([g.means for g in gs])        # [G, M, D]
            # center observations and means by the group's mean-of-means:
            # the quadratic form is shift-invariant, and removing the
            # common offset keeps the expanded o2-2om+mm evaluation from
            # cancelling away f32 precision when features carry a large
            # DC component (e.g. un-normalized log energies)
            center = means.mean(axis=(0, 1))               # [D]
            groups.append((
                np.asarray(idxs, np.int64),
                jnp.asarray(center.astype(np.float32)),
                jnp.asarray((means - center).astype(np.float32)),
                jnp.asarray(1.0 / np.stack([g.variances for g in gs])),
                jnp.asarray(np.log(np.stack([g.weights for g in gs]))
                            - 0.5 * np.stack([g.gconsts for g in gs])),
            ))
        self._gmm_groups_cache = groups
        return groups

    def state_observations(self, obs: jnp.ndarray) -> jnp.ndarray:
        """[T, D] decoder input -> [T, E] per-state observation log-probs.

        PDFObsVec states gather their posterior column; DiagC GMM states
        get batched log-likelihoods — same-shape states stacked into
        [G, M, D] tensors, one quadratic-form einsum + logsumexp per
        distinct (n_mix, dim) shape (DiagCGaussianMixtureDensity,
        Viterbi.cc:719-755, vectorized over states x mixtures)."""
        c = self.c
        if len(c.gmm_states) == 0:
            return obs[:, self.obs_idx]
        cols = obs[:, self.obs_idx]
        n_gmm = len(c.gmm_states)
        parts = []
        rows = []
        for idxs, center, means, inv_var, logw_half in self._gmm_groups():
            # q[t,g,m] = sum_d (obs[t,d]-mu[g,m,d])^2 / var[g,m,d]
            #   expanded: obs^2 . iv  -  2 obs . (mu iv)  +  sum mu^2 iv
            # (obs and mu are pre-centered by the group mean — see
            # _gmm_groups — so the expansion keeps f32 precision)
            oc = obs - center[None, :]
            o2 = jnp.einsum("td,gmd->tgm", oc * oc, inv_var,
                            precision=jax.lax.Precision.HIGHEST)
            om = jnp.einsum("td,gmd->tgm", oc, means * inv_var,
                            precision=jax.lax.Precision.HIGHEST)
            mm = jnp.sum(means * means * inv_var, axis=-1)   # [G, M]
            comp = logw_half[None] - 0.5 * (o2 - 2.0 * om + mm[None])
            parts.append(jax.scipy.special.logsumexp(comp, axis=-1))
            rows.append(idxs)
        gll_cat = jnp.concatenate(parts, axis=1)             # [T, n_gmm]
        perm = np.empty(n_gmm, np.int64)
        perm[np.concatenate(rows)] = np.arange(n_gmm)
        gll = gll_cat[:, perm]
        is_gmm = jnp.asarray(c.gmm_index >= 0)
        gidx = jnp.asarray(np.maximum(c.gmm_index, 0))
        return jnp.where(is_gmm[None, :], gll[:, gidx], cols)

    # -- carried-state block scan (streaming + batch share this core) ----
    def init_carry(self):
        """Network state after ViterbiInit: empty models, initial entry
        closure applied (stkinterface.cpp:163-211)."""
        c = self.c
        entry0, entry_edge0, entry_wt0 = self._init_entry()
        return (jnp.full((c.n_states,), NEG, jnp.float32),
                jnp.zeros((c.n_states,), jnp.int32),
                jnp.asarray(entry0), jnp.asarray(entry_edge0),
                jnp.asarray(entry_wt0))

    def _step_fn(self, n_valid, beam):
        """One ViterbiStep as segment-max reductions.  ``beam`` is the
        pruning width (net.mPruningThresh, Viterbi.cc:1359-1360): values
        below best - beam are killed; pass OFF_BEAM to disable."""
        c = self.c
        E, M = c.n_states, c.n_models
        n_cm = self.cm_src.shape[0]

        def dense_max_argmax(vals, dense):
            """Per-destination max + first-wins argmax over the dense
            incoming-edge table (rows ascending by edge id, -1 padded;
            index -1 wraps to the appended NEG sentinel)."""
            v = jnp.concatenate([vals, jnp.full((1,), NEG, vals.dtype)])
            picked = v[dense]                           # [num, K]
            mx = jnp.max(picked, axis=1)
            k = jnp.argmax(picked, axis=1)              # first max = low id
            am = jnp.take_along_axis(dense, k[:, None], axis=1)[:, 0]
            return mx, am.astype(jnp.int32)

        in_src_m = self.in_src.clip(0, M - 1)
        in_src_s = self.in_src.clip(0, E - 1)

        def step(carry, inputs):
            alpha, wt, entry, entry_edge, entry_wt = carry
            obs_t, t = inputs

            # in-model propagation: from old alpha / entry values
            src_val = jnp.where(self.in_entry, entry[in_src_m],
                                alpha[in_src_s])
            src_wt = jnp.where(self.in_entry, entry_wt[in_src_m],
                               wt[in_src_s])
            vals = src_val + self.in_w
            new_alpha, in_am = dense_max_argmax(vals, self.in_dense)
            new_wt = src_wt[in_am.clip(0, vals.shape[0] - 1)]
            new_alpha = new_alpha + obs_t
            # beam pruning against the best token like (Viterbi.cc:1359)
            thresh = jnp.max(new_alpha) - beam
            new_alpha = jnp.where(new_alpha >= thresh, new_alpha, NEG)
            # exit: from UPDATED alpha (Viterbi.cc:1663-1686)
            ex_vals = new_alpha[self.ex_src] + self.ex_w
            exit_val, ex_am = dense_max_argmax(ex_vals, self.ex_dense)
            exit_wt = new_wt[self.ex_src[ex_am.clip(0, ex_vals.shape[0]
                                                    - 1)]]

            # network closure: model exits -> entries & sinks
            cm_vals = exit_val[self.cm_src.clip(0)] + self.cm_w
            cm_vals = jnp.where(self.cm_src < 0, NEG, cm_vals)
            nentry, cm_am = dense_max_argmax(cm_vals, self.cm_dense)
            nentry = jnp.where(nentry >= thresh, nentry, NEG)
            cm_am_c = cm_am.clip(0, n_cm - 1)
            nentry_wt = jnp.where(
                self.cm_reset[cm_am_c], t,
                exit_wt[self.cm_src.clip(0)[cm_am_c]])

            if self.cs_src.shape[0] > 0:
                cs_vals = exit_val[self.cs_src.clip(0)] + self.cs_w
                cs_vals = jnp.where(self.cs_src < 0, NEG, cs_vals)
                sink_val, cs_am = dense_max_argmax(cs_vals, self.cs_dense)
                sink_wt = exit_wt[self.cs_src.clip(0)[
                    cs_am.clip(0, cs_vals.shape[0] - 1)]]
            else:
                sink_val = jnp.full((self.n_sinks,), NEG, jnp.float32)
                cs_am = jnp.zeros((self.n_sinks,), jnp.int32)
                sink_wt = jnp.zeros((self.n_sinks,), jnp.int32)

            rec = dict(in_am=in_am, ex_am=ex_am, cm_am=cm_am,
                       entry_edge=entry_edge, entry_val=entry,
                       sink_val=sink_val, cs_am=cs_am, sink_wt=sink_wt,
                       exit_val=exit_val)
            new_carry = (new_alpha, new_wt, nentry, cm_am_c, nentry_wt)
            valid = t <= n_valid
            carry = jax.tree_util.tree_map(
                lambda n, o: jnp.where(valid, n, o), new_carry,
                (alpha, wt, entry, entry_edge, entry_wt))
            return carry, rec

        return step

    @partial(jax.jit, static_argnums=(0, 6))
    def scan_block(self, carry, obs_state: jnp.ndarray, t0, n_valid, beam,
                   unroll: int = 1):
        """Scan a block of frames from an explicit carry (streaming chunk
        or whole utterance).  obs_state: [Tb, E]; ``t0`` = count of frames
        decoded before this block (times are 1-based, so the block covers
        t0+1..t0+Tb); ``n_valid`` = absolute valid frame count (padded
        steps pass the carry through).  ``unroll`` amortizes scan-loop
        overhead for narrow serving scans (keep 1 for wide batches)."""
        T = obs_state.shape[0]
        tt = jnp.int32(t0) + jnp.arange(1, T + 1, dtype=jnp.int32)
        return jax.lax.scan(self._step_fn(n_valid, beam), carry,
                            (obs_state, tt), unroll=unroll)

    def _scan(self, obs_state: jnp.ndarray, n_valid, beam=None):
        beam = OFF_BEAM if beam is None else beam
        return self.scan_block(self.init_carry(), obs_state, 0,
                               jnp.int32(n_valid), jnp.float32(beam))[1]

    # ------------------------------------------------------------------
    def _run_scan(self, obs, beam=None):
        """Pad T to a bucket so the scan compiles once per bucket size."""
        obs = np.asarray(obs)
        T = obs.shape[0]
        bucket = max(256, 1 << (T - 1).bit_length())
        if bucket > T:
            obs = np.concatenate(
                [obs, np.zeros((bucket - T, obs.shape[1]), obs.dtype)])
        obs_state = self.state_observations(jnp.asarray(obs))
        recs = jax.tree_util.tree_map(
            np.asarray, self._scan(obs_state, jnp.int32(T), beam))
        return jax.tree_util.tree_map(lambda a: a[:T], recs)

    def decode(self, obs, beam=None) -> List[Label]:
        """Full decode: obs [T, D] log posteriors -> word labels (the
        TimePruning + ViterbiDone output).  Routed through the BATCHED
        scan + device traceback at B=1 — one scan dispatch plus one
        traceback dispatch instead of a per-frame Python walk (the host
        walk remains only for stitched streaming records)."""
        obs = np.asarray(obs)
        T = obs.shape[0]
        bucket = max(256, 1 << (T - 1).bit_length())
        if bucket > T:
            obs = np.concatenate(
                [obs, np.zeros((bucket - T, obs.shape[1]), obs.dtype)])
        return self.decode_batch(obs[None], np.asarray([T], np.int32),
                                 beam=beam)[0]

    def traceback_host(self, recs, frame_offset: int = 0,
                       boundary: bool = False,
                       like_offset: float = 0.0) -> List[Label]:
        """Host traceback over (possibly stitched streaming) records.

        ``frame_offset`` shifts emitted label times (records are a
        retained window starting at that absolute frame); ``boundary``
        marks that row 0 is NOT the utterance start but a commit point —
        a walk reaching it stops there (its words were already emitted
        with the committed prefix), the fixed-lag forced-commit semantics
        of the reference's TimePruning ring (Viterbi.cc:65-125)."""
        T = recs["in_am"].shape[0]
        c = self.c
        # final like: terminal sink at last frame
        if c.terminal_sink < 0 or recs["sink_val"][T - 1, c.terminal_sink] \
                <= NEG / 2:
            return []
        # walk back: sink closure edge -> src model exit -> state chain
        words: List[Tuple[str, int, float]] = []   # (word, end_t, like)

        def note_words(edge_words, t, like):
            for w in reversed(edge_words):
                words.append((w, t, like))

        cs_edge = self.cs[int(recs["cs_am"][T - 1, c.terminal_sink])]
        like = float(recs["sink_val"][T - 1, c.terminal_sink])
        note_words(cs_edge.words, T, like)
        model = cs_edge.src
        t = T - 1
        # state at frame t: via exit argmax of model
        while model >= 0 and t >= 0:
            ex_k = int(recs["ex_am"][t, model])
            state = int(c.ex_src[ex_k])
            # walk within frames until an entry edge is used
            while True:
                k = int(recs["in_am"][t, state])
                if bool(c.in_src_is_entry[k]):
                    m = int(c.in_src[k])
                    # entry value at frame t was produced by closure at
                    # frame t-1 (or the init closure at t == 0)
                    if t == 0:
                        if not boundary:
                            ek = int(recs["entry_edge"][0, m])
                            e = self.cm[ek]
                            note_words(e.words, 0,
                                       float(recs["entry_val"][0, m]))
                            model = e.src
                        else:
                            # commit point: the crossing words here were
                            # already part of the committed prefix
                            model = -1
                        t = -1
                        break
                    ek = int(recs["cm_am"][t - 1, m])
                    e = self.cm[ek]
                    note_words(e.words, t, float(recs["entry_val"][t, m]))
                    model = e.src
                    t = t - 1
                    break
                state = int(c.in_src[k])
                t -= 1
                if t < 0:
                    model = -1
                    break
            if model < 0:
                break
        words.reverse()
        labels: List[Label] = []
        # record values are cumulative path likes (the scan carry runs
        # across the whole stream); a retained window starts at the
        # committed path's cumulative like, not zero
        prev_t, prev_like = 0, like_offset
        for w, end_t, like in words:
            labels.append(Label(prev_t + frame_offset,
                                end_t + frame_offset, w, like - prev_like))
            prev_t, prev_like = end_t, like
        return labels

    # ------------------------------------------------------------------
    # batched decode: vmapped scan + device-side traceback
    # ------------------------------------------------------------------
    @partial(jax.jit, static_argnums=0)
    def _scan_batch(self, obs_state: jnp.ndarray, n_valid: jnp.ndarray,
                    beam):
        """[B, T, E] per-state observations + [B] valid counts -> records
        with a leading batch axis, one dispatch."""
        def one(obs, nv):
            return self.scan_block(self.init_carry(), obs, 0, nv, beam)[1]
        return jax.vmap(one)(obs_state, n_valid)

    @partial(jax.jit, static_argnums=0)
    def _traceback_batch(self, recs, n_valid: jnp.ndarray,
                         frame0: "jnp.ndarray | None" = None):
        """Device-side replay of decode()'s host walk, vmapped over rows.

        Each reverse step consumes exactly one frame: either an in-model
        hop (edge recorded in in_am) or a model-entry hop, which crosses
        one closure edge (cm_am at the previous frame).  Emits per frame
        the crossed closure-edge id (-1 if none) and the entry value at
        the crossing — the host expands edge ids to word sequences.
        Returns (ok, sink_edge, sink_val, edge_ids [T], edge_vals [T]).

        ``frame0`` (per row, default -1): committed fixed-lag boundary in
        WINDOW-relative frames — crossings at t <= frame0 are suppressed
        (their words were already emitted with the committed prefix) and
        the walk stops there, the forced-commit semantics of the
        reference's TimePruning ring (Viterbi.cc:65-125).  -1 means row 0
        is the true utterance start (the t=0 crossing walks the recorded
        entry_edge — for a continuation window that record holds the
        closure argmax of the last pre-window frame, so the same code
        path serves both)."""
        c = self.c
        T = recs["in_am"].shape[1]
        n_cm = max(len(self.cm), 1)
        if frame0 is None:
            frame0 = jnp.full(n_valid.shape, -1, jnp.int32)

        def one(rec, nv, f0):
            last = jnp.maximum(nv - 1, 0)
            sink_edge = rec["cs_am"][last, c.terminal_sink].astype(jnp.int32)
            sink_val = rec["sink_val"][last, c.terminal_sink]
            ok = (nv > 0) & (sink_val > NEG / 2)
            e0 = sink_edge.clip(0, max(self.cs_src.shape[0] - 1, 0))
            model0 = jnp.where(ok, self.cs_src[e0], -1)
            st0 = jnp.where(
                model0 >= 0,
                self.ex_src[rec["ex_am"][last, model0.clip(0)]
                            .astype(jnp.int32)], 0)

            def rstep(carry, t):
                state, model, active = carry
                # skip padded frames (t >= nv) and finished rows
                live = active & (t < nv) & (model >= 0)
                k = rec["in_am"][t, state].astype(jnp.int32)
                is_entry = self.in_entry[k]
                # in-model hop
                nxt_state = self.in_src_s_dev[k]
                # entry hop: cross the closure edge taken at frame t-1
                m = self.in_src_m_dev[k]
                ek = jnp.where(t == 0, rec["entry_edge"][0, m],
                               rec["cm_am"][jnp.maximum(t - 1, 0), m]
                               ).astype(jnp.int32)
                ek = ek.clip(0, n_cm - 1)
                eval_ = rec["entry_val"][t, m]
                src_model = self.cm_src[ek]
                # after crossing: resume at src model's exit state (t-1)
                tm1 = jnp.maximum(t - 1, 0)
                res_state = self.ex_src[
                    rec["ex_am"][tm1, src_model.clip(0)]
                    .astype(jnp.int32)]
                crossed = live & is_entry
                emit = crossed & (t > f0)
                out_edge = jnp.where(emit, ek, -1)
                out_val = jnp.where(emit, eval_, 0.0)
                state = jnp.where(live,
                                  jnp.where(is_entry, res_state, nxt_state),
                                  state)
                model = jnp.where(crossed, src_model, model)
                active = active & ~(crossed & (src_model < 0)) \
                    & ~(t == 0) & ~(crossed & (t <= f0))
                return (state, model, active), (out_edge, out_val)

            (_, _, _), (edges, vals) = jax.lax.scan(
                rstep, (st0, model0, ok & (model0 >= 0)),
                jnp.arange(T - 1, -1, -1, dtype=jnp.int32))
            # emitted in reverse time order; flip to ascending frame index
            return ok, sink_edge, sink_val, edges[::-1], vals[::-1]

        return jax.vmap(one)(recs, n_valid, frame0)

    def labels_from_edge_walk(self, ok_b, sink_edge_b, sink_val_b,
                              edges_b, vals_b, n_valid: int,
                              frame_offset: int = 0, frame0_rel: int = 0,
                              like0: float = 0.0) -> List[Label]:
        """Host expansion of ONE row of _traceback_batch output into word
        labels: crossed closure-edge ids -> word sequences, likes as
        cumulative-path deltas.  ``frame0_rel``/``like0`` seed the first
        label's start frame and like base (the committed boundary);
        ``frame_offset`` shifts window-relative frames to absolute."""
        if not ok_b:
            return []
        words: List[Tuple[str, int, float]] = []
        cs_edge = self.cs[int(sink_edge_b)]
        for w in reversed(cs_edge.words):
            words.append((w, n_valid, float(sink_val_b)))
        ts = np.nonzero(np.asarray(edges_b[:n_valid]) >= 0)[0]
        for t in ts[::-1]:
            e = self.cm[int(edges_b[t])]
            for w in reversed(e.words):
                words.append((w, int(t), float(vals_b[t])))
        words.reverse()
        labels: List[Label] = []
        prev_t, prev_like = frame0_rel, like0
        for w, end_t, like in words:
            labels.append(Label(prev_t + frame_offset,
                                end_t + frame_offset, w, like - prev_like))
            prev_t, prev_like = end_t, like
        return labels

    def decode_batch(self, log_post, n_frames, beam=None) -> List[List[Label]]:
        """[B, T, D] log posteriors + [B] frame counts -> per-row word
        labels, scan + traceback each in ONE device dispatch."""
        if self.c.terminal_sink < 0:
            return [[] for _ in range(np.asarray(log_post).shape[0])]
        beam = jnp.float32(OFF_BEAM if beam is None else beam)
        obs = jnp.asarray(log_post)
        obs_state = jax.vmap(self.state_observations)(obs)
        nv = jnp.asarray(n_frames, jnp.int32)
        recs = self._scan_batch(obs_state, nv, beam)
        ok, sink_edge, sink_val, edges, vals = jax.tree_util.tree_map(
            np.asarray, self._traceback_batch(recs, nv))
        n_frames = np.asarray(n_frames)
        return [
            self.labels_from_edge_walk(ok[b], sink_edge[b], sink_val[b],
                                       edges[b], vals[b],
                                       int(n_frames[b]))
            for b in range(obs.shape[0])
        ]

    # ------------------------------------------------------------------
    def kws_scan(self, obs, beam=None):
        """KWS per-frame values: returns (word_sink_vals [T, K],
        filler_vals [T], word_start_times [T, K]) as numpy."""
        recs = self._run_scan(obs, beam)
        c = self.c
        ws = np.asarray(c.kws_word_sinks, np.int32)
        word_vals = recs["sink_val"][:, ws]
        start_times = recs["sink_wt"][:, ws]
        filler = recs["sink_val"][:, c.kws_filler_sink]
        return word_vals, filler, start_times


class DenseKWSScan:
    """Dense max-plus formulation of ViterbiStep for multi-stream KWS
    serving.

    The edge-list step (NetworkDecoder._step_fn) reduces over per-dst
    gather tables, which is latency-bound when vmapped over streams.
    For the small static networks phnrec exercises, the same reductions
    are a broadcast-add + axis-max over dense [SRC, DST] matrices:
    vector work instead of gathers.

    Tie-breaking parity with the edge-list path is EXACT by
    construction: per destination, edge ids ascend with (entry slot,
    then source state / source model) — see compile_network's emission
    order — so laying the SRC axis out as [model entry slots (M), then
    emitting states (E)] makes argmax's first-max-wins pick the same
    winner as the dense table's lowest-edge-id rule.  Parallel edges
    between the same (src, dst) collapse at build time keeping the
    first on ties (strictly-greater build loop).

    Emits only the sink records (sink_val/sink_wt) the KWS tracker
    consumes; decode-mode traceback stays on the edge-list path."""

    def __init__(self, decoder: "NetworkDecoder"):
        c = decoder.c
        M, E = c.n_models, c.n_states
        S = decoder.n_sinks
        self.M, self.E, self.n_sinks = M, E, S
        # edge-id lookup tables alongside the weight matrices: the dense
        # argmax returns the winning SOURCE row; these map (src, dst)
        # back to the edge-list edge id the per-dst-row reduction would
        # have recorded (build keeps the first strictly-greatest edge,
        # matching the ascending-edge-id first-max-wins rule), so the
        # dense scan can emit the SAME traceback records as scan_block
        A_in = np.full((M + E, E), NEG, np.float32)
        I_in = np.full((M + E, E), -1, np.int32)
        for k in range(len(c.in_src)):
            row = (int(c.in_src[k]) if c.in_src_is_entry[k]
                   else M + int(c.in_src[k]))
            dst, w = int(c.in_dst[k]), np.float32(c.in_w[k])
            if w > A_in[row, dst]:
                A_in[row, dst] = w
                I_in[row, dst] = k
        A_ex = np.full((E, M), NEG, np.float32)
        I_ex = np.full((E, M), -1, np.int32)
        for k in range(len(c.ex_src)):
            src, dst = int(c.ex_src[k]), int(c.ex_dst_model[k])
            w = np.float32(c.ex_w[k])
            if w > A_ex[src, dst]:
                A_ex[src, dst] = w
                I_ex[src, dst] = k
        A_cm = np.full((M, M), NEG, np.float32)
        R_cm = np.zeros((M, M), bool)
        I_cm = np.full((M, M), -1, np.int32)
        for k, e in enumerate(decoder.cm):
            if e.src < 0:
                continue           # START closure: handled by init_carry
            w = np.float32(e.score)
            if w > A_cm[e.src, e.dst]:
                A_cm[e.src, e.dst] = w
                R_cm[e.src, e.dst] = e.word_time_reset
                I_cm[e.src, e.dst] = k
        A_cs = np.full((M, max(S, 1)), NEG, np.float32)
        I_cs = np.full((M, max(S, 1)), -1, np.int32)
        for k, e in enumerate(decoder.cs):
            if e.src < 0:
                continue
            w = np.float32(e.score)
            if w > A_cs[e.src, e.sink]:
                A_cs[e.src, e.sink] = w
                I_cs[e.src, e.sink] = k
        self.A_in = jnp.asarray(A_in)
        self.A_ex = jnp.asarray(A_ex)
        self.A_cm = jnp.asarray(A_cm)
        self.R_cm = jnp.asarray(R_cm)
        self.A_cs = jnp.asarray(A_cs)
        # tie-parity invariant, checked at build: per destination, edge
        # ids must ASCEND with source row (compile_network emits in-model
        # edges entry-then-states-ascending per dst, and closure edges
        # grouped by ascending source) — then jnp.argmax's lowest-row
        # tie-break picks exactly the edge the edge-list reduction's
        # lowest-edge-id rule records.  A network violating this would
        # silently break dense/edge-list record parity, so fail loudly.
        for name, tab in (("in", I_in), ("ex", I_ex), ("cm", I_cm),
                          ("cs", I_cs)):
            for d in range(tab.shape[1]):
                ids = tab[tab[:, d] >= 0, d]
                if not np.all(np.diff(ids) > 0):
                    raise AssertionError(
                        f"dense {name}-table edge ids not ascending with "
                        f"source row for dst {d}: tie-breaking would "
                        "diverge from the edge-list scan")
        self.I_in = jnp.asarray(I_in)
        self.I_ex = jnp.asarray(I_ex)
        self.I_cm = jnp.asarray(I_cm)
        self.I_cs = jnp.asarray(I_cs)
        self._entry0, self._entry_edge0, _ = decoder._init_entry()

    def init_carry(self, n: int):
        """[n]-stream carry: (alpha [n,E], wt [n,E], entry [n,M],
        entry_wt [n,M]) — ViterbiInit + the initial entry closure."""
        return (jnp.full((n, self.E), NEG, jnp.float32),
                jnp.zeros((n, self.E), jnp.int32),
                jnp.tile(jnp.asarray(self._entry0)[None], (n, 1)),
                jnp.zeros((n, self.M), jnp.int32))

    def step(self, carry, obs_t, t, live, beam):
        """One ViterbiStep over [n] streams: obs_t [n, E], t [n] global
        1-based frame times, live [n] row mask, beam [n] per-stream
        pruning widths.  Returns (carry', (sink_val [n, S],
        sink_wt [n, S]))."""
        alpha, wt, entry, entry_wt = carry
        src = jnp.concatenate([entry, alpha], axis=1)       # [n, M+E]
        s1 = src[:, :, None] + self.A_in[None]              # [n, M+E, E]
        new_alpha = jnp.max(s1, axis=1) + obs_t
        am1 = jnp.argmax(s1, axis=1)
        src_wt = jnp.concatenate([entry_wt, wt], axis=1)
        new_wt = jnp.take_along_axis(src_wt, am1, axis=1)
        thresh = jnp.max(new_alpha, axis=1, keepdims=True) \
            - jnp.reshape(beam, (-1, 1))
        new_alpha = jnp.where(new_alpha >= thresh, new_alpha, NEG)
        s2 = new_alpha[:, :, None] + self.A_ex[None]        # [n, E, M]
        exit_val = jnp.max(s2, axis=1)
        am2 = jnp.argmax(s2, axis=1)
        exit_wt = jnp.take_along_axis(new_wt, am2, axis=1)
        s3 = exit_val[:, :, None] + self.A_cm[None]         # [n, M, M]
        nentry = jnp.max(s3, axis=1)
        am3 = jnp.argmax(s3, axis=1)
        nentry = jnp.where(nentry >= thresh, nentry, NEG)
        reset = self.R_cm[am3, jnp.arange(self.M)[None, :]]
        nentry_wt = jnp.where(reset, t[:, None],
                              jnp.take_along_axis(exit_wt, am3, axis=1))
        s4 = exit_val[:, :, None] + self.A_cs[None]         # [n, M, S]
        sink_val = jnp.max(s4, axis=1)
        am4 = jnp.argmax(s4, axis=1)
        sink_wt = jnp.take_along_axis(exit_wt, am4, axis=1)
        new = (new_alpha, new_wt, nentry, nentry_wt)
        lv = live[:, None]
        carry = jax.tree_util.tree_map(
            lambda n_, o_: jnp.where(lv, n_, o_), new, carry)
        return carry, (sink_val, sink_wt)

    # -- decode-mode dense step (emits traceback records) ---------------
    def init_carry_decode(self, n: int):
        """[n]-stream decode carry: (alpha [n,E], entry [n,M],
        entry_edge [n,M]) — no word-time rows (decode traceback derives
        times from the records, not sink_wt)."""
        return (jnp.full((n, self.E), NEG, jnp.float32),
                jnp.tile(jnp.asarray(self._entry0)[None], (n, 1)),
                jnp.tile(jnp.asarray(self._entry_edge0)[None], (n, 1)))

    def step_decode(self, carry, obs_t, live, beam):
        """One ViterbiStep over [n] streams emitting the SAME per-frame
        traceback records as NetworkDecoder._step_fn (edge ids via the
        I_* lookups), for the multi-stream decode server.  obs_t [n, E],
        live [n], beam [n].  Returns (carry', rec dict of [n, ...])."""
        alpha, entry, entry_edge = carry
        M, E, S = self.M, self.E, self.n_sinks
        src = jnp.concatenate([entry, alpha], axis=1)       # [n, M+E]
        s1 = src[:, :, None] + self.A_in[None]              # [n, M+E, E]
        new_alpha = jnp.max(s1, axis=1) + obs_t
        am1 = jnp.argmax(s1, axis=1)                        # [n, E]
        in_am = self.I_in[am1, jnp.arange(E)[None, :]]
        thresh = jnp.max(new_alpha, axis=1, keepdims=True) \
            - jnp.reshape(beam, (-1, 1))
        new_alpha = jnp.where(new_alpha >= thresh, new_alpha, NEG)
        s2 = new_alpha[:, :, None] + self.A_ex[None]        # [n, E, M]
        exit_val = jnp.max(s2, axis=1)
        am2 = jnp.argmax(s2, axis=1)
        ex_am = self.I_ex[am2, jnp.arange(M)[None, :]]
        s3 = exit_val[:, :, None] + self.A_cm[None]         # [n, M, M]
        nentry = jnp.max(s3, axis=1)
        am3 = jnp.argmax(s3, axis=1)
        cm_am = self.I_cm[am3, jnp.arange(M)[None, :]]
        nentry = jnp.where(nentry >= thresh, nentry, NEG)
        s4 = exit_val[:, :, None] + self.A_cs[None]         # [n, M, S]
        sink_val = jnp.max(s4, axis=1)
        am4 = jnp.argmax(s4, axis=1)
        cs_am = self.I_cs[am4, jnp.arange(S)[None, :]]
        rec = dict(in_am=in_am, ex_am=ex_am, cm_am=cm_am,
                   entry_edge=entry_edge, entry_val=entry,
                   sink_val=sink_val, cs_am=cs_am)
        new = (new_alpha, nentry, cm_am)
        lv = live[:, None]
        carry = jax.tree_util.tree_map(
            lambda n_, o_: jnp.where(lv, n_, o_), new, carry)
        return carry, rec


@dataclass
class KWSHit:
    word: str
    start: int
    end: int
    score: float
    new_estim: bool = False   # DECMSG_NEWESTIM re-emission (improveKwdEstim)


class KWSTracker:
    """The LRTrace candidate state machine (stkinterface.cpp:240-289,
    349-380) with CARRIED state, vectorized across keywords: per keyword,
    track the likelihood ratio word_end - filler_end; a candidate grows
    while the LR is non-decreasing; a hypothesis with a later start time
    than the candidate's end flushes the candidate.  ``feed`` consumes any
    number of frames (a live chunk or a whole utterance) and returns the
    hits flushed during those frames — the streaming per-frame emission
    the reference produces through its callback."""

    def __init__(self, keywords: Sequence[str],
                 time_pruning: float = 1e9,
                 score_pruning: float = -np.inf,
                 improve_kwd_estim: bool = False,
                 keyword0_time_quirk: bool = True):
        self.keywords = list(keywords)
        self.time_pruning = time_pruning
        self.score_pruning = score_pruning   # kwsScorePruning (LR floor)
        # improveKwdEstim (stkinterface.cpp:350-353): an already-dumped
        # candidate whose end time moved is re-emitted as DECMSG_NEWESTIM
        self.improve_kwd_estim = improve_kwd_estim
        # the reference's time-pruned flush tests `lrt->candidateEndTime`
        # — KEYWORD 0's candidate age — for every keyword
        # (stkinterface.cpp:285-288, an indexing slip).  Kept by default
        # for output parity (it changes which end-time an emitted
        # candidate carries); pass False for the per-keyword check.
        self.keyword0_time_quirk = keyword0_time_quirk
        K = len(keywords)
        self.t = 0                            # frames consumed so far
        self.last_lr = np.full(K, -np.inf)
        self.cand_lr = np.full(K, -np.inf)
        self.cand_start = np.zeros(K, np.int64)
        self.cand_end = np.zeros(K, np.int64)
        self.prev_end = np.zeros(K, np.int64)
        self.dumped = np.zeros(K, bool)
        self.hits: List[KWSHit] = []

    def _flush(self, j: int) -> None:
        """PutKWSCandidateToLabels (stkinterface.cpp:349-377): emit when a
        candidate exists and is undumped (or improved); ``dumped`` is set
        only on emission, exactly as the reference does."""
        improved = (self.improve_kwd_estim and
                    self.cand_end[j] != self.prev_end[j])
        if self.cand_end[j] != 0 and (not self.dumped[j] or improved):
            if self.cand_lr[j] >= self.score_pruning:
                self.hits.append(KWSHit(self.keywords[j],
                                        int(self.cand_start[j]),
                                        int(self.cand_end[j]),
                                        float(self.cand_lr[j]),
                                        new_estim=bool(self.dumped[j])))
            self.prev_end[j] = self.cand_end[j]
            self.dumped[j] = True

    def feed(self, word_vals: np.ndarray, filler: np.ndarray,
             start_times: np.ndarray) -> List[KWSHit]:
        """[F, K] word-end values, [F] filler values, [F, K] word start
        times (absolute frames) -> hits flushed during these frames."""
        first = len(self.hits)
        F, K = word_vals.shape
        for i in range(F):
            t = self.t + i
            active = (word_vals[i] > NEG / 2) & (filler[i] > NEG / 2)
            lr = np.where(active, word_vals[i] - filler[i], -np.inf)
            growing = active & (lr >= self.last_lr)
            ws = start_times[i].astype(np.int64)
            new_hyp = growing & (self.cand_end <= ws)
            take = growing & ((lr >= self.cand_lr) | new_hyp)
            for j in np.nonzero(new_hyp & take)[0]:
                self._flush(int(j))
                self.dumped[j] = False
            self.cand_start = np.where(take, ws, self.cand_start)
            self.cand_end = np.where(take, t + 1, self.cand_end)
            self.cand_lr = np.where(take, lr, self.cand_lr)
            self.last_lr = np.where(active, lr, -np.inf)
            if self.time_pruning < 1e9:
                ref_end = (np.full_like(self.cand_end, self.cand_end[0])
                           if self.keyword0_time_quirk else self.cand_end)
                stale = active & (ref_end != 0) & (
                    (t + 1) - ref_end >= self.time_pruning)
                # _flush itself decides dumped/improved (the reference
                # calls PutKWSCandidateToLabels unconditionally here, so
                # improveKwdEstim re-emissions fire at time-prune points)
                for j in np.nonzero(stale)[0]:
                    self._flush(int(j))
        self.t += F
        return self.hits[first:]

    def finish(self) -> List[KWSHit]:
        """Flush every outstanding candidate (StkInterface::Done)."""
        first = len(self.hits)
        for j in range(len(self.keywords)):
            self._flush(j)
        return self.hits[first:]


def lrtrace_init_state(n_keywords: int):
    """Zero state for the device LRTrace scan ([K] rows)."""
    K = n_keywords
    return (jnp.full((K,), -jnp.inf, jnp.float32),   # last_lr
            jnp.full((K,), -jnp.inf, jnp.float32),   # cand_lr
            jnp.zeros((K,), jnp.int32),              # cand_start
            jnp.zeros((K,), jnp.int32),              # cand_end
            jnp.zeros((K,), jnp.int32),              # prev_end
            jnp.zeros((K,), bool))                   # dumped


def lrtrace_step_fn(time_pruning: float, score_pruning: float,
                    improve_kwd_estim: bool = False,
                    keyword0_time_quirk: bool = True):
    """Pure per-frame LRTrace transition (stkinterface.cpp:240-289,
    349-380) over [K] keyword rows, shared by the single-stream
    DeviceKWSTracker (scan over frames) and the multi-stream server
    (vmapped over streams).  ``inputs`` = (word_vals [K], filler scalar,
    word_starts [K], t scalar, live scalar) — a dead frame (live=False,
    e.g. a padded row of a ragged multi-stream block) passes the state
    through and emits nothing.  Emits two flush-event slots per frame
    (new-hypothesis flush, then the time-pruning flush), in the
    reference's callback order."""
    tp = float(time_pruning)
    sp = np.float32(score_pruning)
    improve = bool(improve_kwd_estim)
    quirk = bool(keyword0_time_quirk)

    def flush(cand_lr, cand_start, cand_end, prev_end, dumped, cond):
        improved = improve & (cand_end != prev_end) \
            if improve else jnp.zeros_like(dumped)
        do = cond & (cand_end != 0) & (~dumped | improved)
        emit = do & (cand_lr >= sp)
        rec = dict(emit=emit, start=cand_start, end=cand_end,
                   score=cand_lr, new_estim=dumped)
        prev_end = jnp.where(do, cand_end, prev_end)
        dumped = jnp.where(do, True, dumped)
        return rec, prev_end, dumped

    def step(st, inputs):
        old = st
        last_lr, cand_lr, cand_start, cand_end, prev_end, dumped = st
        wv, fl, ws, t, live = inputs
        active = (wv > NEG / 2) & (fl > NEG / 2)
        lr = jnp.where(active, wv - fl, -jnp.inf)
        growing = active & (lr >= last_lr)
        new_hyp = growing & (cand_end <= ws)
        take = growing & ((lr >= cand_lr) | new_hyp)
        ev1 = new_hyp & take
        rec1, prev_end, dumped = flush(
            cand_lr, cand_start, cand_end, prev_end, dumped, ev1)
        dumped = jnp.where(ev1, False, dumped)
        cand_start = jnp.where(take, ws, cand_start)
        cand_end = jnp.where(take, t + 1, cand_end)
        cand_lr = jnp.where(take, lr, cand_lr)
        last_lr = jnp.where(active, lr, -jnp.inf)
        if tp < 1e9:
            # the reference tests KEYWORD 0's candidate age for every
            # keyword (stkinterface.cpp:285-288, kept by default)
            ref_end = (jnp.broadcast_to(cand_end[0], cand_end.shape)
                       if quirk else cand_end)
            stale = active & (ref_end != 0) & \
                ((t + 1) - ref_end >= jnp.int32(int(tp)))
            rec2, prev_end, dumped = flush(
                cand_lr, cand_start, cand_end, prev_end, dumped, stale)
        else:
            rec2 = jax.tree_util.tree_map(jnp.zeros_like, rec1)
        new = (last_lr, cand_lr, cand_start, cand_end, prev_end, dumped)
        st = jax.tree_util.tree_map(
            lambda n_, o_: jnp.where(live, n_, o_), new, old)
        rec1 = dict(rec1, emit=rec1["emit"] & live)
        rec2 = dict(rec2, emit=rec2["emit"] & live)
        return st, (rec1, rec2)

    return step


def flush_outstanding_candidates(state_np, keywords,
                                 score_pruning: float) -> List[KWSHit]:
    """StkInterface::Done's final candidate flush from a fetched LRTrace
    state tuple ([K]-shaped leaves, one stream): emit each undumped
    candidate that clears the kwsScorePruning floor, in keyword order
    (mirrors KWSTracker._flush with improve_kwd_estim final semantics)."""
    (_, cand_lr, cand_start, cand_end, _, dumped) = state_np
    hits: List[KWSHit] = []
    for j in range(len(keywords)):
        if cand_end[j] != 0 and not dumped[j] \
                and cand_lr[j] >= score_pruning:
            hits.append(KWSHit(keywords[j], int(cand_start[j]),
                               int(cand_end[j]), float(cand_lr[j])))
    return hits


def decode_lrtrace_events(events_np, keywords) -> List[KWSHit]:
    """Host decode of fetched flush-event records for ONE stream:
    (rec1, rec2) dicts of [F, K] arrays -> hits in the reference's
    callback order (frame-major, new-hyp slot before time-prune slot)."""
    rec1, rec2 = events_np
    emit = np.stack([np.asarray(rec1["emit"]),
                     np.asarray(rec2["emit"])], axis=1)     # [F, 2, K]
    hits: List[KWSHit] = []
    if not emit.any():
        return hits
    recs = [rec1, rec2]
    for t, slot, j in zip(*np.nonzero(emit)):
        r = recs[slot]
        hits.append(KWSHit(
            keywords[j],
            int(np.asarray(r["start"])[t, j]),
            int(np.asarray(r["end"])[t, j]),
            float(np.asarray(r["score"])[t, j]),
            new_estim=bool(np.asarray(r["new_estim"])[t, j])))
    return hits


class DeviceKWSTracker:
    """LRTrace candidate tracking carried ON DEVICE (the state machine of
    stkinterface.cpp:240-289/349-380, same semantics as KWSTracker, as a
    jitted scan over frames).

    The host tracker costs one BLOCKING device->host fetch of the sink
    values per block — through a high-latency link that serializes the
    live decode.  Here the per-keyword candidate state ([K] rows of
    last/candidate LR, start/end times, dumped flags) rides inside a
    device scan; only compact flush-event records leave the device, and
    only when the host asks (collect()), so chunk latency no longer
    scales with link round trips.  Up to two flushes can fire per
    keyword per frame (a new-hypothesis flush of the previous candidate,
    then a time-pruning flush), emitted as two event slots whose
    frame-major order reproduces the reference's callback order."""

    def __init__(self, keywords: Sequence[str],
                 time_pruning: float = 1e9,
                 score_pruning: float = -np.inf,
                 improve_kwd_estim: bool = False,
                 keyword0_time_quirk: bool = True,
                 word_sinks: Optional[Sequence[int]] = None,
                 filler_sink: Optional[int] = None):
        self.keywords = list(keywords)
        self.hits: List[KWSHit] = []
        K = len(keywords)
        self.t = 0
        self._pending: List = []
        # sink-column extraction happens INSIDE the jitted scan when the
        # sink layout is given (no eager slicing per block)
        self._ws = (None if word_sinks is None
                    else jnp.asarray(np.asarray(word_sinks, np.int32)))
        self._fs = filler_sink
        self.score_pruning = float(score_pruning)
        self._finished = False
        self.state = lrtrace_init_state(K)
        step = lrtrace_step_fn(time_pruning, score_pruning,
                               improve_kwd_estim, keyword0_time_quirk)

        @jax.jit
        def scan(st, wv, fl, ws, t0):
            F = wv.shape[0]
            tt = jnp.int32(t0) + jnp.arange(F, dtype=jnp.int32)
            live = jnp.ones((F,), bool)
            return jax.lax.scan(step, st, (wv, fl, ws, tt, live))

        self._scan = scan
        ws_idx, fs_idx = self._ws, self._fs

        @jax.jit
        def scan_sinks(st, sink_val, sink_wt, t0):
            wv = sink_val[:, ws_idx]
            fl = sink_val[:, fs_idx]
            ws = sink_wt[:, ws_idx].astype(jnp.int32)
            F = wv.shape[0]
            tt = jnp.int32(t0) + jnp.arange(F, dtype=jnp.int32)
            live = jnp.ones((F,), bool)
            return jax.lax.scan(step, st, (wv, fl, ws, tt, live))

        self._scan_sinks = scan_sinks if ws_idx is not None else None

    def feed_device(self, word_vals, filler, start_times) -> None:
        """Track a block of DEVICE-resident sink records [F, K]/[F]/[F, K]
        (no host transfer happens here)."""
        self.state, events = self._scan(
            self.state, word_vals, filler,
            jnp.asarray(start_times).astype(jnp.int32), self.t)
        self.t += int(word_vals.shape[0])
        self._pending.append(events)

    def feed_sinks(self, sink_val, sink_wt) -> None:
        """Track a block straight from the decoder's raw sink records
        [F, n_sinks] (column extraction fused into the scan dispatch)."""
        self.state, events = self._scan_sinks(
            self.state, sink_val, sink_wt, self.t)
        self.t += int(sink_val.shape[0])
        self._pending.append(events)

    def collect(self) -> List[KWSHit]:
        """Fetch all pending flush events in ONE transfer and append the
        decoded hits (reference callback order: frame-major, new-hyp
        slot before the time-pruning slot)."""
        if not self._pending:
            return []
        fetched = jax.device_get(self._pending)
        self._pending = []
        first = len(self.hits)
        for events in fetched:
            self.hits.extend(decode_lrtrace_events(events, self.keywords))
        return self.hits[first:]

    def finish(self) -> List[KWSHit]:
        """Flush every outstanding candidate (StkInterface::Done): fetch
        the carried state once and run the host flush per keyword.
        Idempotent, like the host tracker whose _flush marks candidates
        dumped: a second finish() adds nothing."""
        first = len(self.hits)
        self.collect()
        if self._finished:
            return self.hits[first:]
        self._finished = True
        self.hits.extend(flush_outstanding_candidates(
            jax.device_get(self.state), self.keywords,
            self.score_pruning))
        return self.hits[first:]


def kws_candidates(word_vals: np.ndarray, filler: np.ndarray,
                   start_times: np.ndarray, keywords: Sequence[str],
                   time_pruning: float = 1e9,
                   score_pruning: float = -np.inf) -> List[KWSHit]:
    """Whole-utterance KWS: feed all frames through a tracker + final
    flush (identical to the streaming emission, which is the point —
    offline and live KWS share one state machine)."""
    tr = KWSTracker(keywords, time_pruning, score_pruning)
    tr.feed(word_vals, filler, start_times)
    tr.finish()
    hits = sorted(tr.hits, key=lambda h: (h.start, h.end, h.word))
    return hits


class StkNetworkDecoder:
    """Pipeline-facing adapter (the StkInterface equivalent): owns the
    parsed HMM set + network and dispatches decode vs. KWS mode."""

    def __init__(self, model_set: ModelSet, network: StkNetwork,
                 wpenalty: float, lm_scale: float, mode: str = "decode",
                 time_pruning: int = 40,
                 keyword_thresholds=None,
                 beam_pruning: Optional[float] = None,
                 kws_score_pruning: float = -np.inf):
        self.model_set = model_set
        self.network = network
        self.lm_scale = lm_scale
        self.mode = mode
        self.time_pruning = time_pruning
        self.keyword_thresholds = keyword_thresholds
        # stkinterface.h:107-113 knob surface: beamPruning (width against
        # the best token like; off by default as in stkinterface.cpp:26)
        # and kwsScorePruning (candidate LR floor)
        self.beam_pruning = beam_pruning
        self.kws_score_pruning = kws_score_pruning
        self._build(wpenalty)

    def _build(self, wpenalty: float) -> None:
        self.wpenalty = wpenalty
        self.compiled = compile_network(self.network, self.model_set,
                                        wpenalty, self.lm_scale)
        self.decoder = NetworkDecoder(self.compiled)

    def set_wpenalty(self, wpenalty: float) -> None:
        self._build(wpenalty)

    # SetBeamPruning / SetKwsScorePruning / SetTimePruning
    # (stkinterface.h:107-113)
    def set_beam_pruning(self, v: Optional[float]) -> None:
        self.beam_pruning = v

    def set_kws_score_pruning(self, v: float) -> None:
        self.kws_score_pruning = v

    def set_time_pruning(self, v: int) -> None:
        self.time_pruning = v

    def keywords(self) -> List[str]:
        return [self.compiled.sink_names[s]
                for s in self.compiled.kws_word_sinks]

    def _xform(self, log_post):
        # global <InputXform>: transform observations before scoring
        # (ModelSet::UpdateStacks per ViterbiStep, Viterbi.cc:2068 — here
        # the whole utterance is transformed at once)
        if self.model_set.input_xform is not None:
            from phnrec_tpu.io.xform import apply_instance
            log_post = apply_instance(self.model_set.input_xform, log_post)
        return log_post

    def decode(self, log_post) -> List[Label]:
        log_post = self._xform(log_post)
        if self.mode == "kws":
            wv, fv, st = self.decoder.kws_scan(log_post,
                                               beam=self.beam_pruning)
            hits = kws_candidates(wv, fv, st, self.keywords(),
                                  self.time_pruning,
                                  self.kws_score_pruning)
            # NOTE: thresholds filter only the LIVE callback output in the
            # reference (phnrec.cpp:81-83); label files keep every
            # candidate (PutKWSCandidateToLabels).  Callers needing the
            # live behavior filter via self.keyword_thresholds.
            return [Label(h.start, h.end, h.word, h.score) for h in hits]
        return self.decoder.decode(log_post, beam=self.beam_pruning)

    def decode_batch(self, log_post, n_frames) -> List[List[Label]]:
        """Batched decode-mode: [B, T, D] + [B] -> per-row labels in one
        scan dispatch + one traceback dispatch.  The global <InputXform>
        is applied HERE (only), so NetworkDecoder.decode and .decode_batch
        see identical (already-transformed) observations."""
        if self.mode == "kws":
            lp_np = np.asarray(log_post)     # ONE fetch for the batch
            return [self.decode(lp_np[b, : int(n)])
                    for b, n in enumerate(np.asarray(n_frames))]
        if self.model_set.input_xform is not None:
            log_post = jax.vmap(self._xform)(jnp.asarray(log_post))
        return self.decoder.decode_batch(log_post, n_frames,
                                         beam=self.beam_pruning)

    @classmethod
    def from_config(cls, sr, cfg) -> "StkNetworkDecoder":
        from phnrec_tpu.io.mmf import parse_mmf
        from phnrec_tpu.io.stknet import parse_stk_network
        from phnrec_tpu.netgen import generate_resources

        generate_resources(cfg)
        ms = parse_mmf(cfg.get_str("models", "hmm_defs"))
        net = parse_stk_network(cfg.get_str("networks", "default"))
        mode = cfg.get_str("decoder", "mode")
        thr = None
        if mode == "kws":
            from phnrec_tpu.kws import Thresholds
            thr = Thresholds.from_config(cfg)
        # beam_pruning/kws_score_pruning: engine knobs behind
        # stkinterface.h:107-113 setters.  The reference registers no
        # config keys for them (stkinterface.cpp:26 defaults = off); we
        # accept optional decoder/beam_pruning + kws/score_pruning keys
        # as a documented extension.
        b = cfg.get_float("decoder", "beam_pruning")
        beam = b if b > 0 else None
        ksp = cfg.get_float("kws", "score_pruning")
        return cls(ms, net,
                   wpenalty=cfg.get_float("decoder", "wpenalty"),
                   lm_scale=cfg.get_float("decoder", "lm_scale"),
                   mode=mode,
                   time_pruning=cfg.get_int("decoder", "time_pruning"),
                   keyword_thresholds=thr,
                   beam_pruning=beam,
                   kws_score_pruning=ksp)
