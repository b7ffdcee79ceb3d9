"""Graph networks over static graphs (counterpart of
``paddlescience_tpu/arch/graph_nets.py``).

* ``CrystalGraphConvNet`` (reference ``ppsci/arch/crystalgraphconvnet.py``),
  CGCNN: gated neighbour convolutions, crystal mean pooling;
* ``TGCN`` (reference ``ppsci/arch/tgcn.py``): dilated temporal
  convolutions and K-hop dense-adjacency graph convolutions;
* ``MeshGraphNet``, the encode-process-decode core of ``AMGNet``
  (reference ``ppsci/arch/amgnet.py``; greedy AMG-style aggregation
  computed on the host, :meth:`AMGNet.coarsen`), ``CFDGCN`` (reference
  ``ppsci/arch/cfdgcn.py``; any callable coarse solver) and
  ``GraphCastNet`` (reference ``ppsci/arch/graphcast.py``; an icosahedral
  multi-mesh and its grid wiring built on the host, :func:`build_multimesh`).

Every sum of messages and every row gather goes through
``nn/segment.py``: a graph's senders and receivers (host arrays) give
their stable sorting order and segment offsets once, so forward and
backward repeat bitwise on the card, read nothing back to the host and
can be captured in a CUDA graph. The graph construction (coarsening, the multi-mesh, GraphCast's
nearest-vertex wiring) is the JAX package's numpy, call for call, so the
integer arrays are the same.

Parameter names are the JAX tree's (``blocks.0.edge_fc1.weight``,
``tc1.convs.1.weight``, ``bn1.scale``, ...), so ``utils/jax_params.py``
carries JAX weights key for key. ``TGCN`` runs channel-first: (B, C, N, T)
inside, where the JAX module runs (B, N, T, C); its ``_BatchStatNorm``
normalises with the current batch's mean and population variance, and its
dropout draws from the generator that ``set_train_rng`` installs (the
``Solver`` hands over its own each train step, None in eval).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.device import DeviceLike
from paddlescience_torch.nn.layers import Conv, LayerNorm, Linear
from paddlescience_torch.nn.segment import Segments, gather, segment_sum, segments

__all__ = ["CrystalGraphConvNet", "TGCN", "MeshGraphNet", "AMGNet", "GraphCastNet", "CFDGCN", "build_multimesh",
           "graphcast_wiring"]

Gen = Optional[torch.Generator]


def _gen(generator: Gen) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


# ------------------------------------------------------------------ CGCNN --


class _CGConvLayer(nn.Module):
    """CGCNN gated neighbour aggregation (reference crystalgraphconvnet.py:7),
    with LayerNorm in place of BatchNorm1D, as in the JAX package."""

    def __init__(self, atom_fea_len: int, nbr_fea_len: int, *, generator: torch.Generator):
        super().__init__()
        self.atom_fea_len = atom_fea_len
        self.fc_full = Linear(2 * atom_fea_len + nbr_fea_len, 2 * atom_fea_len, generator=generator)
        self.norm1 = LayerNorm(2 * atom_fea_len)
        self.norm2 = LayerNorm(atom_fea_len)

    def forward(self, atom_in_fea, nbr_fea, nbr_seg: Segments):
        N, M = nbr_fea.shape[:2]
        atom_nbr_fea = gather(atom_in_fea, nbr_seg).view(N, M, self.atom_fea_len)
        total = torch.cat([atom_in_fea[:, None].expand(N, M, self.atom_fea_len), atom_nbr_fea, nbr_fea], dim=2)
        gated = self.norm1(self.fc_full(total))
        nbr_filter, nbr_core = torch.chunk(gated, 2, dim=2)
        nbr_sumed = torch.sum(torch.sigmoid(nbr_filter) * F.softplus(nbr_core), dim=1)
        return F.softplus(atom_in_fea + self.norm2(nbr_sumed))


class CrystalGraphConvNet(Arch):
    """CGCNN property predictor. Input ``x["i"] = (atom_fea (N, F0),
    nbr_fea (N, M, Fn), nbr_fea_idx (N, M), crystal_atom_idx)``: the two
    feature tensors on the model's device, the neighbour indices a host
    array and ``crystal_atom_idx`` a list of host index arrays, one per
    crystal (its atoms' rows). Output ``{"out": (n_crystals, 1)}``."""

    def __init__(self, orig_atom_fea_len: int, nbr_fea_len: int, atom_fea_len: int = 64, n_conv: int = 3,
                 h_fea_len: int = 128, n_h: int = 1, *, generator: Gen = None, device: DeviceLike = None):
        super().__init__()
        g = _gen(generator)
        self.input_keys = ("i",)
        self.output_keys = ("out",)
        self.embedding = Linear(orig_atom_fea_len, atom_fea_len, generator=g)
        self.convs = nn.ModuleList(_CGConvLayer(atom_fea_len, nbr_fea_len, generator=g) for _ in range(n_conv))
        self.conv_to_fc = Linear(atom_fea_len, h_fea_len, generator=g)
        self.fcs = nn.ModuleList(Linear(h_fea_len, h_fea_len, generator=g) for _ in range(n_h - 1))
        self.fc_out = Linear(h_fea_len, 1, generator=g)
        if device is not None:
            self.to(device)

    @staticmethod
    def pooling_segments(crystal_atom_idx: Sequence, n_atoms: int) -> Tuple[Segments, Segments]:
        """(the gather of every crystal's atoms in turn, the segments that
        sum them per crystal) for a list of per-crystal index arrays."""
        parts = [np.asarray(ix).reshape(-1) for ix in crystal_atom_idx]
        rows = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        owner = np.repeat(np.arange(len(parts)), [len(p) for p in parts])
        return segments(rows, n_atoms), segments(owner, len(parts))

    def forward(self, x: Dict) -> Dict[str, torch.Tensor]:
        atom_fea, nbr_fea, nbr_fea_idx, crystal_atom_idx = x[self.input_keys[0]]
        n_atoms = atom_fea.shape[0]
        nbr_seg = segments(nbr_fea_idx, n_atoms)
        h = self.embedding(atom_fea)
        for conv in self.convs:
            h = conv(h, nbr_fea, nbr_seg)
        rows, owner = self.pooling_segments(crystal_atom_idx, n_atoms)
        pooled = segment_sum(gather(h, rows), owner, owner.num_segments) / owner.counts_on(h.device, h.dtype)
        z = F.softplus(self.conv_to_fc(F.softplus(pooled)))
        for fc in self.fcs:
            z = F.softplus(fc(z))
        return {self.output_keys[0]: self.fc_out(z)}


# ------------------------------------------------------------------- TGCN --


class _GRUCell(nn.Module):
    """A GRU cell on concatenated [x, h] (the JAX package's ``_GRUCell``)."""

    def __init__(self, in_dim: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        self.wz = Linear(in_dim + hidden, hidden, generator=generator)
        self.wr = Linear(in_dim + hidden, hidden, generator=generator)
        self.wh = Linear(in_dim + hidden, hidden, generator=generator)

    def forward(self, x, h):
        xh = torch.cat([x, h], dim=-1)
        z = torch.sigmoid(self.wz(xh))
        r = torch.sigmoid(self.wr(xh))
        hh = torch.tanh(self.wh(torch.cat([x, r * h], dim=-1)))
        return (1 - z) * h + z * hh


class _BatchStatNorm(nn.Module):
    """Per-channel normalisation with the current batch's statistics over
    every axis but the channel axis (1): the mean and the population
    variance, ``(x - mean) * rsqrt(var + 1e-5) * scale + shift``; no
    running statistics (the JAX package's stand-in for BatchNorm2D)."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.shift = nn.Parameter(torch.zeros(channels))

    def forward(self, x):  # (B, C, ...)
        axes = (0,) + tuple(range(2, x.ndim))
        mu = torch.mean(x, dim=axes, keepdim=True)
        var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mu) * torch.rsqrt(var + 1e-5) * self.scale.view(shape) + self.shift.view(shape)


class _TempolConv(nn.Module):
    """Dilated temporal convolutions (reference tgcn.py tempol_conv:38-72):
    ``num_layer`` (1, k_s) convolutions of dilation i + 1 padded by i + 1
    on the time axis, each followed by LeakyReLU, their outputs and the
    input concatenated and mixed by a 1x1 convolution. (B, C, N, T)."""

    def __init__(self, in_dim, out_dim, hidden, num_layer=3, k_s=3, alpha=0.1, *, generator: torch.Generator):
        super().__init__()
        self.alpha = alpha
        self.convs = nn.ModuleList(
            Conv(in_dim if i == 0 else hidden, hidden, (1, k_s), padding=[(0, 0), (i + 1, i + 1)],
                 dilation=(1, i + 1), generator=generator) for i in range(num_layer))
        self.mlp = Conv(in_dim + hidden * num_layer, out_dim, (1, 1), generator=generator)

    def forward(self, x):
        cat = [x]
        for conv in self.convs:
            x = F.leaky_relu(conv(x), self.alpha)
            cat.append(x)
        return self.mlp(torch.cat(cat, dim=1))


class _GraphConv(nn.Module):
    """K-hop propagation over a dense adjacency and a 1x1 mix (reference
    tgcn.py graph_conv:12-35); dropout after the mix when a generator is
    given (a kept entry scaled by 1 / keep)."""

    def __init__(self, in_dim, out_dim, dropout, num_layer=2, *, generator: torch.Generator):
        super().__init__()
        self.mlp = Conv((num_layer + 1) * in_dim, out_dim, (1, 1), generator=generator)
        self.num_layer = num_layer
        self.dropout = float(dropout)

    def forward(self, x, adj, gen: Gen = None):  # x (B, C, N, T)
        out = [x]
        for _ in range(self.num_layer):
            x = torch.einsum("mn,bcnt->bcmt", adj, x)
            out.append(x)
        h = self.mlp(torch.cat(out, dim=1))
        if gen is not None and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        return h


class TGCN(Arch):
    """Temporal graph convolutional network (reference ppsci/arch/tgcn.py:
    74-200): a 1x1 embedding, two [dilated temporal convolutions -> K-hop
    graph convolution -> residual -> batch-statistics norm] stages, a dense
    readout over the concatenated features and a (1, input_len)
    convolution to label_len steps. Input (B, T, N, C) -> output (B,
    label_len, N, 1). ``adj`` (N, N) is a constant buffer (not saved)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], adj, in_dim: int = 1,
                 emb_dim: int = 32, hidden: int = 64, gc_layer: int = 2, tc_layer: int = 2, k_s: int = 3,
                 dropout: float = 0.25, alpha: float = 0.1, input_len: int = 12, label_len: int = 12, *,
                 generator: Gen = None, device: DeviceLike = None):
        super().__init__()
        g = _gen(generator)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.register_buffer("adj", torch.as_tensor(np.asarray(adj, np.float32)), persistent=False)
        self._train_gen: Gen = None
        self.emb_conv = Conv(in_dim, emb_dim, (1, 1), generator=g)
        self.tc1 = _TempolConv(emb_dim, hidden, hidden, tc_layer, k_s, alpha, generator=g)
        self.sc1 = _GraphConv(hidden, hidden, dropout, gc_layer, generator=g)
        self.bn1 = _BatchStatNorm(hidden)
        self.tc2 = _TempolConv(hidden, hidden, hidden, tc_layer, k_s, alpha, generator=g)
        self.sc2 = _GraphConv(hidden, hidden, dropout, gc_layer, generator=g)
        self.bn2 = _BatchStatNorm(hidden)
        self.end_conv_1 = Conv(emb_dim + 2 * hidden, 2 * hidden, (1, 1), generator=g)
        self.end_conv_2 = Conv(2 * hidden, label_len, (1, input_len), padding=[(0, 0), (0, 0)], generator=g)
        if device is not None:
            self.to(device)

    def set_train_rng(self, generator: Gen) -> None:
        """Install the generator that dropout draws from in the following
        forwards (None: no dropout)."""
        self._train_gen = generator

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        seq = x[self.input_keys[0]]  # (B, T, N, C)
        h = seq.permute(0, 3, 2, 1)  # (B, C, N, T)
        gen = self._train_gen
        emb = self.emb_conv(h)
        tc1 = self.tc1(emb)
        sc1 = self.bn1(self.sc1(tc1, self.adj, gen) + tc1)
        tc2 = self.tc2(sc1)
        sc2 = self.bn2(self.sc2(tc2, self.adj, gen) + tc2)
        out = F.relu(torch.cat([emb, sc1, sc2], dim=1))
        out = F.relu(self.end_conv_1(out))
        return {self.output_keys[0]: self.end_conv_2(out)}  # (B, label_len, N, 1)


# ------------------------------------------------------- message passing --


class _MPBlock(nn.Module):
    """Edge and node update (MeshGraphNet): edges from [edge, sender,
    receiver], nodes from [node, sum of incoming edges], each an MLP, a
    LayerNorm and a residual."""

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        self.edge_fc1 = Linear(3 * dim, dim, generator=generator)
        self.edge_fc2 = Linear(dim, dim, generator=generator)
        self.edge_norm = LayerNorm(dim)
        self.node_fc1 = Linear(2 * dim, dim, generator=generator)
        self.node_fc2 = Linear(dim, dim, generator=generator)
        self.node_norm = LayerNorm(dim)

    def forward(self, nodes, edges, senders: Segments, receivers: Segments):
        e_in = torch.cat([edges, gather(nodes, senders), gather(nodes, receivers)], dim=-1)
        e = self.edge_norm(self.edge_fc2(F.relu(self.edge_fc1(e_in)))) + edges
        agg = segment_sum(e, receivers, nodes.shape[0])
        n_in = torch.cat([nodes, agg], dim=-1)
        n = self.node_norm(self.node_fc2(F.relu(self.node_fc1(n_in)))) + nodes
        return n, e


class MeshGraphNet(Arch):
    """Encode-process-decode GNN over a static graph. The input key maps to
    ``(node_feats (N, Fn), edge_feats (E, Fe), senders (E,), receivers
    (E,))``: the features on the model's device, the indices host arrays
    (their segment tables are built once per graph)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], node_in_dim: int,
                 edge_in_dim: int, out_dim: int, hidden: int = 128, n_layers: int = 8, *, generator: Gen = None,
                 device: DeviceLike = None):
        super().__init__()
        g = _gen(generator)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.node_enc = Linear(node_in_dim, hidden, generator=g)
        self.edge_enc = Linear(edge_in_dim, hidden, generator=g)
        self.blocks = nn.ModuleList(_MPBlock(hidden, generator=g) for _ in range(n_layers))
        self.decoder = Linear(hidden, out_dim, generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x: Dict) -> Dict[str, torch.Tensor]:
        node_feats, edge_feats, senders, receivers = x[self.input_keys[0]]
        n_nodes = node_feats.shape[0]
        s, r = segments(senders, n_nodes), segments(receivers, n_nodes)
        n = F.relu(self.node_enc(node_feats))
        e = F.relu(self.edge_enc(edge_feats))
        for block in self.blocks:
            n, e = block(n, e, s, r)
        return {self.output_keys[0]: self.decoder(n)}


class AMGNet(MeshGraphNet):
    """AMGNet flow-field predictor (reference ppsci/arch/amgnet.py): a
    graph U-Net whose coarse level comes from greedy AMG-style aggregation
    on the host (:meth:`coarsen`). Input ``(node_feats, edge_feats,
    senders, receivers, assign, coarse_senders, coarse_receivers)`` (index
    arrays on the host); the 4-tuple runs the flat processor. The first
    half of the blocks smooths the fine graph, the aggregate means go
    through two coarse blocks, are added back to their nodes, and the
    second half of the blocks follows."""

    def __init__(self, *args, generator: Gen = None, device: DeviceLike = None, **kwargs):
        g = _gen(generator)
        super().__init__(*args, generator=g, **kwargs)
        hidden = self.node_enc.out_features
        self.coarse_blocks = nn.ModuleList(_MPBlock(hidden, generator=g) for _ in range(2))
        self.coarse_edge_enc = Linear(1, hidden, generator=g)
        if device is not None:
            self.to(device)

    @staticmethod
    def coarsen(senders, receivers, n_nodes):
        """Greedy aggregation: each node not yet aggregated becomes a seed
        and absorbs its unaggregated out-neighbours. Returns (assign (N,),
        coarse_senders, coarse_receivers) as numpy int32 (the JAX
        package's loop)."""
        senders = np.asarray(senders)
        receivers = np.asarray(receivers)
        assign = -np.ones(n_nodes, np.int64)
        order = np.argsort(senders, kind="stable")
        s_sorted, r_sorted = senders[order], receivers[order]
        starts = np.searchsorted(s_sorted, np.arange(n_nodes))
        ends = np.searchsorted(s_sorted, np.arange(n_nodes) + 1)
        n_coarse = 0
        for v in range(n_nodes):
            if assign[v] >= 0:
                continue
            assign[v] = n_coarse
            for u in r_sorted[starts[v]:ends[v]]:
                if assign[u] < 0:
                    assign[u] = n_coarse
            n_coarse += 1
        ce = {(int(assign[s]), int(assign[r])) for s, r in zip(senders, receivers) if assign[s] != assign[r]}
        if not ce:
            ce = {(0, 0)}
        ce = np.asarray(sorted(ce), np.int32)
        return assign.astype(np.int32), ce[:, 0], ce[:, 1]

    def forward(self, x: Dict) -> Dict[str, torch.Tensor]:
        graph = x[self.input_keys[0]]
        if len(graph) == 4:
            return super().forward(x)
        node_feats, edge_feats, senders, receivers, assign, cs, cr = graph
        n_nodes = node_feats.shape[0]
        s, r = segments(senders, n_nodes), segments(receivers, n_nodes)
        assign_host = np.asarray(assign.numpy() if isinstance(assign, torch.Tensor) else assign)
        agg = segments(assign_host, int(assign_host.max()) + 1)
        n = F.relu(self.node_enc(node_feats))
        e = F.relu(self.edge_enc(edge_feats))
        half = len(self.blocks) // 2
        for block in self.blocks[:half]:
            n, e = block(n, e, s, r)
        c = segment_sum(n, agg, agg.num_segments) / agg.counts_on(n.device, n.dtype).clamp(min=1.0)
        ce = F.relu(self.coarse_edge_enc(torch.ones((len(cs), 1), dtype=n.dtype, device=n.device)))
        c_s, c_r = segments(cs, agg.num_segments), segments(cr, agg.num_segments)
        for block in self.coarse_blocks:
            c, ce = block(c, ce, c_s, c_r)
        n = n + gather(c, agg)
        for block in self.blocks[half:]:
            n, e = block(n, e, s, r)
        return {self.output_keys[0]: self.decoder(n)}


# -------------------------------------------------------------- GraphCast --


def _icosahedron():
    phi = (1 + np.sqrt(5)) / 2
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ], np.int64)
    return v, f


def _refine(verts, faces):
    """Midpoint subdivision of every triangle on the unit sphere."""
    verts = list(map(tuple, verts))
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2
            m = tuple(m / np.linalg.norm(m))
            cache[key] = len(verts)
            verts.append(m)
        return cache[key]

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
    return np.asarray(verts), np.asarray(new_faces, np.int64)


def build_multimesh(level: int):
    """GraphCast's multi-mesh: the vertices of the ``level``-times refined
    icosahedron and the union of every refinement level's edges (both
    directions), sorted. Returns (vertices (V, 3) float32, senders,
    receivers) as numpy."""
    verts, faces = _icosahedron()
    edge_set = set()

    def add_edges(fs):
        for a, b, c in fs:
            for i, j in ((a, b), (b, c), (c, a)):
                edge_set.add((i, j))
                edge_set.add((j, i))

    add_edges(faces)
    for _ in range(level):
        verts, faces = _refine(verts, faces)
        add_edges(faces)
    edges = np.asarray(sorted(edge_set), np.int32)
    return verts.astype(np.float32), edges[:, 0], edges[:, 1]


def _edge_feats(pos_s, pos_r):
    d = pos_r - pos_s
    return np.concatenate([d, np.linalg.norm(d, axis=1, keepdims=True)], 1).astype(np.float32)


def graphcast_wiring(lat: int, lon: int, mesh_level: int) -> Dict[str, np.ndarray]:
    """GraphCast's host graphs over [grid 0..ng) then mesh ng..ng+nm):
    every grid point encodes into its nearest mesh vertex (``g2m_*``), the
    processor runs over the multi-mesh (``mesh_*``), each grid point
    decodes from its 3 nearest vertices (``m2g_*``), nearest by cosine
    similarity in float32 (``np.argmax`` and ``np.argsort(-sim)``, the JAX
    package's calls: the pole rows' near-ties break as there). Returns the
    senders, receivers and edge features of each, the mesh positions and
    the counts."""
    mesh_pos, ms, mr = build_multimesh(mesh_level)
    la = np.linspace(-np.pi / 2, np.pi / 2, lat)
    lo = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    LA, LO = np.meshgrid(la, lo, indexing="ij")
    grid_pos = np.stack([np.cos(LA) * np.cos(LO), np.cos(LA) * np.sin(LO), np.sin(LA)], -1)
    grid_pos = grid_pos.reshape(-1, 3).astype(np.float32)
    ng, nm = len(grid_pos), len(mesh_pos)
    sim = grid_pos @ mesh_pos.T
    g2m_r = np.argmax(sim, axis=1)
    m2g_s = np.argsort(-sim, axis=1)[:, :3]
    return {
        "n_grid": ng, "n_mesh": nm, "mesh_pos": mesh_pos,
        "g2m_s": np.arange(ng, dtype=np.int32), "g2m_r": (ng + g2m_r).astype(np.int32),
        "g2m_e": _edge_feats(grid_pos, mesh_pos[g2m_r]),
        "mesh_s": (ng + ms).astype(np.int32), "mesh_r": (ng + mr).astype(np.int32),
        "mesh_e": _edge_feats(mesh_pos[ms], mesh_pos[mr]),
        "m2g_s": (ng + m2g_s.reshape(-1)).astype(np.int32), "m2g_r": np.repeat(np.arange(ng, dtype=np.int32), 3),
        "m2g_e": _edge_feats(mesh_pos[m2g_s.reshape(-1)], np.repeat(grid_pos, 3, axis=0)),
    }


class GraphCastNet(Arch):
    """GraphCast weather GNN (reference ppsci/arch/graphcast.py): grid2mesh
    encoder, multi-mesh processor, mesh2grid decoder over the host graphs
    of :func:`graphcast_wiring` (constant buffers of the module, not
    saved). Input ``(n_grid, F)`` grid features -> ``(n_grid, out_dim)``.
    Without ``lat``/``lon`` it is the flat ``MeshGraphNet`` (its input the
    4-tuple graph), under ``flat``."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], node_in_dim: int,
                 edge_in_dim: int = 4, out_dim: int = 8, hidden: int = 128, n_layers: int = 8,
                 lat: Optional[int] = None, lon: Optional[int] = None, mesh_level: int = 2, *,
                 generator: Gen = None, device: DeviceLike = None):
        super().__init__()
        g = _gen(generator)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.multimesh = lat is not None and lon is not None
        if not self.multimesh:
            self.flat = MeshGraphNet(input_keys, output_keys, node_in_dim, edge_in_dim, out_dim, hidden, n_layers,
                                     generator=g)
        else:
            w = graphcast_wiring(lat, lon, mesh_level)
            self.n_grid, self.n_mesh = w["n_grid"], w["n_mesh"]
            n = self.n_grid + self.n_mesh
            self._segs = {part: (segments(w[part + "_s"], n), segments(w[part + "_r"], n))
                          for part in ("g2m", "mesh", "m2g")}
            for part in ("g2m", "mesh", "m2g"):
                self.register_buffer(f"_{part}_e", torch.from_numpy(w[part + "_e"]), persistent=False)
            self.register_buffer("_mesh_feat", torch.from_numpy(w["mesh_pos"]), persistent=False)
            self.grid_enc = Linear(node_in_dim, hidden, generator=g)
            self.mesh_enc = Linear(3, hidden, generator=g)
            self.e_g2m = Linear(4, hidden, generator=g)
            self.e_mesh = Linear(4, hidden, generator=g)
            self.e_m2g = Linear(4, hidden, generator=g)
            self.g2m_block = _MPBlock(hidden, generator=g)
            self.blocks = nn.ModuleList(_MPBlock(hidden, generator=g) for _ in range(n_layers))
            self.m2g_block = _MPBlock(hidden, generator=g)
            self.decoder = Linear(hidden, out_dim, generator=g)
        if device is not None:
            self.to(device)

    def forward(self, x: Dict) -> Dict[str, torch.Tensor]:
        if not self.multimesh:
            out = self.flat({self.flat.input_keys[0]: x[self.input_keys[0]]})
            return {self.output_keys[0]: out[self.flat.output_keys[0]]}
        grid_feats = x[self.input_keys[0]]
        gf = F.relu(self.grid_enc(grid_feats))
        m = F.relu(self.mesh_enc(self._mesh_feat))
        n = torch.cat([gf, m], dim=0)
        s, r = self._segs["g2m"]
        n, _ = self.g2m_block(n, F.relu(self.e_g2m(self._g2m_e)), s, r)
        s, r = self._segs["mesh"]
        e = F.relu(self.e_mesh(self._mesh_e))
        for block in self.blocks:
            n, e = block(n, e, s, r)
        s, r = self._segs["m2g"]
        n, _ = self.m2g_block(n, F.relu(self.e_m2g(self._m2g_e)), s, r)
        return {self.output_keys[0]: self.decoder(n[: self.n_grid])}


# ----------------------------------------------------------------- CFDGCN --


class CFDGCN(Arch):
    """CFD-informed GCN (reference ppsci/arch/cfdgcn.py): the node features,
    with the coarse solution of ``cfd_solver(node_feats)`` appended when
    one is given, through a ``MeshGraphNet`` (``gnn``). Input: the 4-tuple
    graph."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], node_in_dim: int,
                 edge_in_dim: int, out_dim: int, hidden: int = 128, n_layers: int = 6,
                 cfd_solver: Optional[Callable] = None, *, generator: Gen = None, device: DeviceLike = None):
        super().__init__()
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.cfd_solver = cfd_solver
        self.gnn = MeshGraphNet(("graph",), ("pred",), node_in_dim, edge_in_dim, out_dim, hidden, n_layers,
                                generator=_gen(generator))
        if device is not None:
            self.to(device)

    def forward(self, x: Dict) -> Dict[str, torch.Tensor]:
        node_feats, edge_feats, senders, receivers = x[self.input_keys[0]]
        if self.cfd_solver is not None:
            node_feats = torch.cat([node_feats, self.cfd_solver(node_feats)], dim=-1)
        out = self.gnn({"graph": (node_feats, edge_feats, senders, receivers)})
        return {self.output_keys[0]: out["pred"]}
