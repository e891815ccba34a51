"""Contrib operators of the port (counterpart of
``incubator_mxnet_tpu/ops/contrib.py``; reference src/operator/contrib/):
CTC loss, SSD's MultiBox family with box NMS, bipartite matching, the
RCNN family (Proposal, PSROIPooling and its deformable form, deformable
convolution), fft, quantize and count sketch.

Every op is plain PyTorch on the data's device; the JAX package reaches
no Pallas kernel here.  Where the JAX op is a long sequential scan, the
port computes the same result another way:

* **NMS** (``box_nms``, ``MultiBoxDetection``, ``Proposal``).  The JAX
  op is a scan of N rounds of masked argmax over an N x N IoU matrix.
  The port sorts by score (stable, so ties take the lower index, as
  ``argmax`` does), builds the suppression matrix of the sorted boxes
  in bounded row blocks, and solves ``keep = valid & ~any(keep_j &
  sup_ji, j < i)`` by sweeping it to its fixed point (the greedy result
  is that equation's only solution; after k sweeps the first k boxes are
  final, and a sweep that changes nothing ends it).  ``topk`` keeps the
  first ``topk`` kept boxes in sorted order.  The scan itself stays as
  ``nms_mark_plain``, the plain version the tests hold the fast one to.
* **CTC**.  The alpha recursion, a loop over time under autograd, in the
  JAX op's log domain with a finite ``-1e30``; on a CUDA tensor the
  library's ``torch.nn.functional.ctc_loss`` computes it (CTC is no TPU
  kernel), which gives the same loss and gradient for every feasible
  alignment and +inf (JAX: ~1e30) for an infeasible one.  The route
  follows the data's device, and nothing else.
* **MultiBoxTarget**'s forced matches.  A padding row (class -1) never
  forces a match, as in MXNet; where two valid boxes share a best
  anchor the later one wins, as in the JAX op.  The JAX op's scatter
  lets a padding row that follows a valid box clear its match
  (``ROADMAP.md``, reference caveats); the port does not.
* **bipartite_matching**.  Greedy over the sorted score list: the next
  accepted pair is always the first still-eligible one, so the port
  takes one per round (at most ``min(N, M)`` rounds) instead of one
  scan step per pair.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import alias_op, register_op

__all__ = ["box_iou_corner", "ctc_loss_plain", "nms_mark", "nms_mark_plain",
           "library_ctc_calls"]

_NEG = -1e30  # log-domain -inf that stays finite under arithmetic

# launches of the library CTC on the card (the CUDA route); the plain
# recursion is not counted
library_ctc_calls = [0]


# ----------------------------------------------------------------- CTC loss
def ctc_loss_plain(log_probs, labels, t_lens, l_lens, blank):
    """The JAX op's alpha recursion over a batch: ``log_probs`` (T, B, A)
    log-softmax activations, ``labels`` (B, L) padded, ``t_lens`` /
    ``l_lens`` (B,) lengths.  Returns -log p(labels | probs), (B,)."""
    T, B, A = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev = log_probs.device
    labels = labels.long()
    # extended sequence: blank, l1, blank, l2, ..., blank
    ext = torch.full((B, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    prev2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long, device=dev),
                       ext[:, :-2]], 1)
    can_skip = (ext != blank) & (ext != prev2)
    # a padding label of -1 reads the last class, as JAX's negative index
    lp = torch.gather(log_probs, 2, (ext % A)[None].expand(T, B, S))
    neg = torch.full((B, 1), _NEG, dtype=log_probs.dtype, device=dev)
    first = torch.where((l_lens > 0)[:, None], lp[0, :, 1:2], neg)
    alpha = torch.cat([lp[0, :, :1], first, neg.expand(B, S - 2)], 1)
    for t in range(1, T):
        a1 = torch.cat([neg, alpha[:, :-1]], 1)
        a2 = torch.cat([neg, neg, alpha[:, :-2]], 1)
        a2 = torch.where(can_skip, a2, neg)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + lp[t]
        alpha = torch.where((t < t_lens)[:, None], new, alpha)
    end = (2 * l_lens).long()[:, None]
    last = torch.gather(alpha, 1, end)[:, 0]
    before = torch.gather(alpha, 1, (end - 1).clamp(min=0))[:, 0]
    before = torch.where(l_lens > 0, before, neg[:, 0])
    return -torch.logaddexp(last, before)


def _ctc_library(log_probs, labels, t_lens, l_lens, blank):
    """The same loss by ``torch.nn.functional.ctc_loss`` (the CUDA
    route): padding labels beyond each length are never read, so they
    become 0; lengths go as int64."""
    library_ctc_calls[0] += 1
    targets = torch.where(labels >= 0, labels, torch.zeros_like(labels))
    return F.ctc_loss(log_probs, targets.long(), t_lens.long(),
                      l_lens.long(), blank=blank, reduction="none",
                      zero_infinity=False)


@register_op("_contrib_ctc_loss", aliases=("ctc_loss", "CTCLoss"))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None, *,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first"):
    """Connectionist temporal classification loss (reference
    src/operator/contrib/ctc_loss.cc).  data (T, B, A) pre-softmax
    activations; label (B, L) class indices, padded.  ``blank_label``
    'first': blank = 0 and labels 1-based, padded with 0; 'last': blank
    = A-1, labels 0-based, padded with -1.  Returns (B,) losses."""
    T, B, A = data.shape
    log_probs = torch.log_softmax(data, dim=-1)
    labels = label.long()
    blank = 0 if blank_label == "first" else A - 1
    if data_lengths is not None and use_data_lengths:
        t_lens = data_lengths.long()
    else:
        t_lens = torch.full((B,), T, dtype=torch.long, device=data.device)
    if label_lengths is not None and use_label_lengths:
        l_lens = label_lengths.long()
    else:
        valid = labels > 0 if blank_label == "first" else labels >= 0
        l_lens = valid.sum(1)
    if data.is_cuda:
        return _ctc_library(log_probs, labels, t_lens, l_lens, blank)
    return ctc_loss_plain(log_probs, labels, t_lens, l_lens, blank)


# ------------------------------------------------------------ MultiBoxPrior
@register_op("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",))
def _multibox_prior(data, *, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes (reference contrib/multibox_prior.cc): data (B, C, H,
    W) gives the map's geometry; output (1, H*W*(S+R-1), 4) corner boxes
    in [0, 1] coordinates, every size at ratios[0], then sizes[0] at the
    other ratios."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    sizes = tuple(np.asarray(sizes, np.float32).tolist())
    ratios = tuple(np.asarray(ratios, np.float32).tolist())
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    whs = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0])) for s in sizes]
    whs += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
            for r in ratios[1:]]
    boxes = [torch.stack([gx - float(bw) / 2, gy - float(bh) / 2,
                          gx + float(bw) / 2, gy + float(bh) / 2], -1)
             for bw, bh in whs]
    out = torch.stack(boxes, 2).reshape(1, h * w * len(whs), 4)
    return out.clamp(0.0, 1.0) if clip else out


def box_iou_corner(a, b):
    """IoU between box sets a (..., Na, 4) and b (..., Nb, 4), corner
    format, in the JAX op's order of operations."""
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    ix1 = torch.maximum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.maximum(ay1[..., :, None], by1[..., None, :])
    ix2 = torch.minimum(ax2[..., :, None], bx2[..., None, :])
    iy2 = torch.minimum(ay2[..., :, None], by2[..., None, :])
    iw = torch.clamp(ix2 - ix1, min=0.0)
    ih = torch.clamp(iy2 - iy1, min=0.0)
    inter = iw * ih
    area_a = torch.clamp((ax2 - ax1) * (ay2 - ay1), min=0.0)
    area_b = torch.clamp((bx2 - bx1) * (by2 - by1), min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


@register_op("_contrib_box_iou", aliases=("box_iou",))
def _box_iou(lhs, rhs, *, format="corner"):
    """(reference contrib/bounding_box.cc box_iou)"""
    if format == "center":
        def corners(b):
            x, y, w, h = b.unbind(-1)
            return torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2],
                               -1)
        lhs, rhs = corners(lhs), corners(rhs)
    return box_iou_corner(lhs, rhs)


# ------------------------------------------------------------ MultiBoxTarget
def _encode(m_box, anc, variances):
    """Offsets of matched boxes from their anchors, in center form over
    the variances."""
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    gw = m_box[..., 2] - m_box[..., 0]
    gh = m_box[..., 3] - m_box[..., 1]
    gcx = (m_box[..., 0] + m_box[..., 2]) / 2
    gcy = (m_box[..., 1] + m_box[..., 3]) / 2
    eps = 1e-8
    aw_, ah_ = aw.clamp(min=eps), ah.clamp(min=eps)
    tx = (gcx - acx) / aw_ / variances[0]
    ty = (gcy - acy) / ah_ / variances[1]
    tw = torch.log((gw / aw_).clamp(min=eps)) / variances[2]
    th = torch.log((gh / ah_).clamp(min=eps)) / variances[3]
    return torch.stack([tx, ty, tw, th], -1)


@register_op("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
             num_outputs=3)
def _multibox_target(anchor, label, cls_pred, *, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5,
                     variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (reference contrib/multibox_target.cc).
    anchor (1, A, 4); label (B, G, 5) rows [cls, x1, y1, x2, y2], cls -1
    for padding; cls_pred (B, classes+1, A) gives only the shape, as the
    reference's path without negative mining.  Each valid box forces a
    match on its best anchor; any other anchor whose best IoU reaches
    the threshold matches its best box.  Returns (loc_target (B, A*4),
    loc_mask (B, A*4), cls_target (B, A), 0 for background)."""
    A = anchor.shape[1]
    B, G, _ = label.shape
    anc = anchor[0]
    gt_cls = label[..., 0]
    gt_box = label[..., 1:5]
    valid = gt_cls >= 0
    iou = box_iou_corner(anc[None], gt_box)                    # (B, A, G)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(2)
    best_gt = iou.argmax(2)           # first of equal maxima, as jnp.argmax
    best_anchor = iou.argmax(1)                                # (B, G)
    # forced matches without a scatter of duplicate indices: hit[b, a, g]
    # when valid box g's best anchor is a; the last such g wins
    hit = (torch.arange(A, device=anc.device)[None, :, None]
           == best_anchor[:, None, :]) & valid[:, None, :]
    forced = hit.any(2)
    forced_gt = (G - 1) - hit.flip(2).to(torch.uint8).argmax(2)
    matched = forced | (best_iou >= overlap_threshold)
    match_gt = torch.where(forced, forced_gt, best_gt)
    m_box = torch.gather(gt_box, 1, match_gt[..., None].expand(B, A, 4))
    m_cls = torch.gather(gt_cls, 1, match_gt)
    loc = _encode(m_box, anc, variances)                       # (B, A, 4)
    mask = matched[..., None].to(anchor.dtype)
    loc_target = (loc * mask).reshape(B, A * 4)
    loc_mask = mask.expand(B, A, 4).reshape(B, A * 4)
    cls_target = torch.where(matched, m_cls + 1.0, torch.zeros_like(m_cls))
    return loc_target, loc_mask, cls_target


# ----------------------------------------------------------------- box_nms
def nms_mark_plain(boxes, scores, iou_thresh, topk):
    """The JAX op's greedy NMS, round for round: N rounds of masked
    argmax over the N x N IoU matrix.  The plain version of
    ``nms_mark`` (one launch chain a round: slow on the card)."""
    n = boxes.shape[0]
    iou = box_iou_corner(boxes, boxes)
    alive = scores > float("-inf")
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    ar = torch.arange(n, device=boxes.device)
    kept = 0
    neg = torch.full_like(scores, float("-inf"))
    for _ in range(n):
        cand = torch.where(alive, scores, neg)
        i = int(torch.argmax(cand))
        ok = bool(cand[i] > float("-inf")) and (topk < 0 or kept < topk)
        if not ok:      # every later round keeps nothing either
            break
        keep[i] = True
        alive = alive & ~(iou[i] > iou_thresh) & (ar != i)
        kept += 1
    return keep


def _suppression(boxes, iou_thresh, block):
    """``sup[i, j] = iou(i, j) > thresh`` for ``j > i`` (boxes in sorted
    order), built ``block`` rows at a time so that no N x N float
    matrix is held."""
    n = boxes.shape[0]
    sup = torch.empty((n, n), dtype=torch.bool, device=boxes.device)
    col = torch.arange(n, device=boxes.device)
    for r0 in range(0, n, block):
        rows = boxes[r0:r0 + block]
        s = box_iou_corner(rows, boxes) > iou_thresh
        sup[r0:r0 + block] = s & (col[None, :] >
                                  col[r0:r0 + rows.shape[0], None])
    return sup


def nms_mark(boxes, scores, iou_thresh, topk, block=2048):
    """The keep mask of ``nms_mark_plain`` by a sort and a fixed-point
    sweep (module note): equal for every input, ties and ``topk``
    included, in a few dozen launches where the scan takes N rounds."""
    n = boxes.shape[0]
    order = torch.sort(scores, descending=True, stable=True).indices
    # the valid boxes lead the sorted order; only they can be kept
    nv = int((scores > float("-inf")).sum())
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    if nv == 0:
        return out
    order = order[:nv]
    sup = _suppression(boxes[order], iou_thresh, block).to(boxes.dtype)
    keep = torch.ones(nv, dtype=torch.bool, device=boxes.device)
    while True:
        new = (keep.to(boxes.dtype)[None, :] @ sup)[0] == 0
        if torch.equal(new, keep):
            break
        keep = new
    if topk >= 0:
        keep = keep & (torch.cumsum(keep.to(torch.int64), 0) <= topk)
    out[order] = keep
    return out


@register_op("_contrib_box_nms", aliases=("box_nms",), differentiable=False)
def _box_nms(data, *, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
             coord_start=2, score_index=1, id_index=-1, force_suppress=False,
             in_format="corner", out_format="corner"):
    """Non-maximum suppression (reference contrib/bounding_box.cc): data
    (..., N, K) rows [.., score, .., x1, y1, x2, y2, ..]; the suppressed
    rows become -1, the shape stays.  With ``id_index`` and without
    ``force_suppress`` only boxes of one class suppress each other (the
    boxes offset by class * 1e3, as in the JAX op)."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    outs = []
    for batch in flat:
        scores = batch[:, score_index]
        boxes = batch[:, coord_start:coord_start + 4]
        eff = torch.where(scores > valid_thresh, scores,
                          torch.full_like(scores, float("-inf")))
        if id_index >= 0 and not force_suppress:
            boxes = boxes + batch[:, id_index:id_index + 1] * 1e3
        keep = nms_mark(boxes, eff, overlap_thresh, topk)
        outs.append(torch.where(keep[:, None], batch,
                                torch.full_like(batch, -1.0)))
    return torch.stack(outs).reshape(shape)


# --------------------------------------------------------- MultiBoxDetection
def _decode(loc_pred, anchor, variances, clip):
    B = loc_pred.shape[0]
    anc = anchor[0]
    A = anc.shape[0]
    loc = loc_pred.reshape(B, A, 4)
    aw = anc[:, 2] - anc[:, 0]
    ah = anc[:, 3] - anc[:, 1]
    acx = (anc[:, 0] + anc[:, 2]) / 2
    acy = (anc[:, 1] + anc[:, 3]) / 2
    cx = loc[..., 0] * variances[0] * aw + acx
    cy = loc[..., 1] * variances[1] * ah + acy
    w = torch.exp(loc[..., 2] * variances[2]) * aw
    h = torch.exp(loc[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return boxes.clamp(0.0, 1.0) if clip else boxes


def detections(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
               background_id=0, variances=(0.1, 0.1, 0.2, 0.2)):
    """``MultiBoxDetection``'s rows before NMS: (B, A, 6) [class, score,
    x1, y1, x2, y2], -1 where the best class's score is under
    ``threshold``."""
    boxes = _decode(loc_pred, anchor, variances, clip)
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], 1)
    best = fg.argmax(1)
    score = torch.gather(fg, 1, best[:, None])[:, 0]
    keep = score > threshold
    neg = torch.full_like(score, -1.0)
    return torch.cat([torch.where(keep, best.to(boxes.dtype), neg)[..., None],
                      torch.where(keep, score, neg)[..., None], boxes], -1)


@register_op("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
             differentiable=False)
def _multibox_detection(cls_prob, loc_pred, anchor, *, clip=True,
                        threshold=0.01, background_id=0, nms_threshold=0.5,
                        force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """Decode and NMS into detections (reference
    contrib/multibox_detection.cc): cls_prob (B, classes+1, A) softmax
    probabilities, background first; loc_pred (B, A*4); anchor (1, A,
    4).  Output (B, A, 6) rows [class, score, x1, y1, x2, y2], -1 for
    the suppressed and the invalid."""
    det = detections(cls_prob, loc_pred, anchor, clip, threshold,
                     background_id, variances)
    return _box_nms(det, overlap_thresh=nms_threshold, valid_thresh=0.0,
                    topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                    force_suppress=force_suppress)


# ------------------------------------------------------------------ Proposal
def _proposal_anchors(H, W, scales, ratios, feature_stride, device):
    base = []
    cx = cy = (feature_stride - 1) / 2.0
    for r in ratios:
        size = feature_stride * feature_stride
        ws = np.round(np.sqrt(size / r))
        hs = np.round(ws * r)
        for s in scales:
            w2, h2 = ws * s / 2.0, hs * s / 2.0
            base.append([cx - w2 + 0.5, cy - h2 + 0.5,
                         cx + w2 - 0.5, cy + h2 - 0.5])
    base = torch.tensor(np.array(base, np.float32), device=device)
    sx = torch.arange(W, dtype=torch.float32, device=device) * feature_stride
    sy = torch.arange(H, dtype=torch.float32, device=device) * feature_stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


@register_op("_contrib_Proposal", aliases=("Proposal",),
             differentiable=False)
def _proposal(cls_prob, bbox_pred, im_info, *, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
              feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposals (reference contrib/proposal.cc): cls_prob (B, 2K, H,
    W), bbox_pred (B, 4K, H, W), im_info (B, 3) [height, width, scale].
    Output (B*post, 5) [batch index, x1, y1, x2, y2]: each image's top
    ``pre`` boxes by score (ties to the lower index), NMS, the survivors
    first in score order, then the suppressed with score -1."""
    B, _, H, W = cls_prob.shape
    K = len(scales) * len(ratios)
    anchors = _proposal_anchors(H, W, scales, ratios, feature_stride,
                                cls_prob.device)
    N = H * W * K
    pre = min(int(rpn_pre_nms_top_n), N)
    post = int(rpn_post_nms_top_n)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    all_b, all_s = [], []
    for b in range(B):
        fg = cls_prob[b, K:].permute(1, 2, 0).reshape(-1)
        d = bbox_pred[b].permute(1, 2, 0).reshape(-1, 4)
        info = im_info[b]
        cx2 = d[:, 0] * aw + acx
        cy2 = d[:, 1] * ah + acy
        w2 = torch.exp(d[:, 2].clamp(-10, 10)) * aw
        h2 = torch.exp(d[:, 3].clamp(-10, 10)) * ah
        boxes = torch.stack([cx2 - w2 / 2, cy2 - h2 / 2,
                             cx2 + w2 / 2, cy2 + h2 / 2], -1)
        hi = torch.stack([info[1] - 1, info[0] - 1, info[1] - 1,
                          info[0] - 1])
        boxes = torch.minimum(boxes.clamp(min=0.0), hi)
        min_size = rpn_min_size * info[2]
        keep = ((boxes[:, 2] - boxes[:, 0] + 1 >= min_size) &
                (boxes[:, 3] - boxes[:, 1] + 1 >= min_size))
        fg = torch.where(keep, fg, torch.full_like(fg, float("-inf")))
        top_s, top_i = torch.sort(fg, descending=True, stable=True)
        top_s, top_i = top_s[:pre], top_i[:pre]
        top_b = boxes[top_i]
        nms_keep = nms_mark(top_b, top_s, threshold, post)
        order = torch.sort((~nms_keep).to(torch.uint8), stable=True).indices
        sel = order[:post]
        out_b = top_b[sel]
        out_s = torch.where(nms_keep[sel], top_s[sel],
                            torch.full_like(top_s[sel], -1.0))
        out_b = torch.where((out_s > float("-inf"))[:, None], out_b,
                            top_b[0])
        all_b.append(out_b)
        all_s.append(out_s)
    boxes = torch.stack(all_b)
    scores = torch.stack(all_s)
    batch_ix = torch.arange(B, dtype=boxes.dtype,
                            device=boxes.device).repeat_interleave(post)
    rois = torch.cat([batch_ix[:, None], boxes.reshape(B * post, 4)], 1)
    if output_score:
        return rois, scores.reshape(B * post, 1)
    return rois


@register_op("_contrib_MultiProposal", aliases=("MultiProposal",),
             differentiable=False)
def _multi_proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """Batched RPN proposals (reference contrib/multi_proposal.cc):
    ``Proposal`` already takes a batch."""
    return _proposal(cls_prob, bbox_pred, im_info, **kwargs)


# --------------------------------------------------------------------- fft
@register_op("_contrib_fft", aliases=("fft",))
def _fft(data, *, compute_size=128):
    """FFT of the last axis, complex packed as interleaved re/im pairs
    (reference contrib/fft.cc: (N, d) -> (N, 2d))."""
    out = torch.fft.fft(data, dim=-1)
    inter = torch.stack([out.real, out.imag], -1)
    return inter.reshape(tuple(data.shape[:-1]) +
                         (2 * data.shape[-1],)).to(data.dtype)


@register_op("_contrib_ifft", aliases=("ifft",))
def _ifft(data, *, compute_size=128):
    """Inverse of ``fft``: (N, 2d) interleaved -> (N, d) real, not
    normalised (scale by 1/d to recover fft's input), as cuFFT's inverse
    in the reference."""
    d = data.shape[-1] // 2
    pairs = data.reshape(tuple(data.shape[:-1]) + (d, 2))
    comp = torch.complex(pairs[..., 0], pairs[..., 1])
    out = torch.fft.ifft(comp, dim=-1) * d
    return out.real.to(data.dtype)


# ---------------------------------------------------------------- quantize
@register_op("_contrib_quantize", aliases=("quantize",), num_outputs=3,
             differentiable=False)
def _quantize(data, min_range, max_range, *, out_type="uint8"):
    """Affine uint8 / int8 quantisation (reference contrib/quantize.cc),
    rounding half to even."""
    if out_type == "uint8":
        qmin, qmax, dt = 0.0, 255.0, torch.uint8
    else:
        qmin, qmax, dt = -127.0, 127.0, torch.int8
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = (qmax - qmin) / torch.clamp(hi - lo, min=1e-8)
    q = torch.clamp(torch.round((data - lo) * scale + qmin), qmin, qmax)
    return q.to(dt), lo.reshape(1), hi.reshape(1)


@register_op("_contrib_dequantize", aliases=("dequantize",))
def _dequantize(data, min_range, max_range, *, out_type="float32"):
    """(reference contrib/dequantize.cc)"""
    if data.dtype == torch.uint8:
        qmin, qmax = 0.0, 255.0
    else:
        qmin, qmax = -127.0, 127.0
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = torch.clamp(hi - lo, min=1e-8) / (qmax - qmin)
    out = (data.to(torch.float32) - qmin) * scale + lo
    return out.to(getattr(torch, out_type))


# ------------------------------------------------------------- PSROIPooling
def _psroi_channel_index(output_dim, group_size, pooled_size, device):
    """cin[ctop, i, j] = (ctop * G + gh) * G + gw, with (gh, gw) the
    group cell of bin (i, j) (reference contrib/psroi_pooling.cc)."""
    bins = np.arange(pooled_size)
    g = np.floor(bins * group_size / pooled_size).astype(np.int64)
    ctop = np.arange(output_dim)[:, None, None]
    cin = (ctop * group_size + g[:, None]) * group_size + g[None, :]
    return torch.tensor(cin, device=device)


def _pick_channels(pooled, cin):
    """out[r, ctop, i, j] = pooled[r, cin[ctop, i, j], i, j]."""
    P = cin.shape[1]
    ii = torch.arange(P, device=cin.device)
    return pooled[:, cin, ii[None, :, None], ii[None, None, :]]


# rois pooled at a time: bounds the (rois, C, H, W) gather
_ROI_CHUNK = 16


@register_op("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def _psroi_pooling(data, rois, *, spatial_scale, output_dim, pooled_size,
                   group_size=0):
    """Position-sensitive ROI pooling (R-FCN; reference
    contrib/psroi_pooling.cc).  data (B, output_dim*G*G, H, W), rois (R,
    5) [batch, x1, y1, x2, y2] in image coordinates; out (R, output_dim,
    P, P): bin (i, j) averages its region of the channel its group cell
    selects, as masked contractions over the whole map."""
    if not group_size:
        group_size = pooled_size
    B, C, H, W = data.shape
    P = int(pooled_size)
    cin = _psroi_channel_index(int(output_dim), int(group_size), P,
                               data.device)
    ys = torch.arange(H, dtype=data.dtype, device=data.device)
    xs = torch.arange(W, dtype=data.dtype, device=data.device)
    i = torch.arange(P, dtype=data.dtype, device=data.device)
    p_t = torch.full((), float(P), dtype=data.dtype, device=data.device)
    outs = []
    for r0 in range(0, rois.shape[0], _ROI_CHUNK):
        roi = rois[r0:r0 + _ROI_CHUNK]
        x1 = torch.round(roi[:, 1]) * spatial_scale
        y1 = torch.round(roi[:, 2]) * spatial_scale
        x2 = (torch.round(roi[:, 3]) + 1.0) * spatial_scale
        y2 = (torch.round(roi[:, 4]) + 1.0) * spatial_scale
        # a true division, as the reference's: the card divides by a
        # Python scalar as a product with its reciprocal, which moves a
        # bin edge that falls on an integer across it (floor / ceil)
        bh = torch.clamp(y2 - y1, min=0.1)[:, None] / p_t
        bw = torch.clamp(x2 - x1, min=0.1)[:, None] / p_t
        hstart = torch.floor(y1[:, None] + i * bh).clamp(0, H)
        hend = torch.ceil(y1[:, None] + (i + 1) * bh).clamp(0, H)
        wstart = torch.floor(x1[:, None] + i * bw).clamp(0, W)
        wend = torch.ceil(x1[:, None] + (i + 1) * bw).clamp(0, W)
        my = ((ys >= hstart[..., None]) & (ys < hend[..., None])
              ).to(data.dtype)                               # (r, P, H)
        mx = ((xs >= wstart[..., None]) & (xs < wend[..., None])
              ).to(data.dtype)                               # (r, P, W)
        count = torch.einsum("rph,rqw->rpq", my, mx)
        d = data.index_select(0, roi[:, 0].long())
        pooled = torch.einsum("rchw,rph,rqw->rcpq", d, my, mx)
        pooled = pooled / torch.clamp(count, min=1.0)[:, None]
        outs.append(_pick_channels(pooled, cin))
    return torch.cat(outs)


# -------------------------------------------- deformable PSROI pooling
def _bilinear(d, y, x):
    """d (r, C, H, W); y / x (r, ...) -> (r, C, ...), bilinear with taps
    outside the map read as 0."""
    r, C, H, W = d.shape
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = y - y0
    wx = x - x0
    flat = d.reshape(r, C, H * W)
    out = 0.0
    for dy, wy_c in ((0, 1 - wy), (1, wy)):
        for dx, wx_c in ((0, 1 - wx), (1, wx)):
            yc = y0 + dy
            xc = x0 + dx
            ok = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
            idx = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            g = torch.gather(flat, 2, idx.reshape(r, 1, -1).expand(r, C, -1))
            g = g.reshape((r, C) + tuple(idx.shape[1:]))
            out = out + g * (wy_c * wx_c * ok.to(d.dtype))[:, None]
    return out


@register_op("_contrib_DeformablePSROIPooling",
             aliases=("DeformablePSROIPooling",))
def _deformable_psroi_pooling(data, rois, trans=None, *, spatial_scale,
                              output_dim, pooled_size, group_size=0,
                              part_size=0, sample_per_part=4,
                              trans_std=0.0, no_trans=False):
    """Deformable position-sensitive ROI pooling (reference
    contrib/deformable_psroi_pooling.cc): each bin averages a
    ``sample_per_part`` square grid of bilinear samples, shifted by the
    normalised offsets of ``trans`` (R, 2, part, part) times
    ``trans_std`` and the roi's size; ``no_trans`` means no shift."""
    if not group_size:
        group_size = pooled_size
    if not part_size:
        part_size = pooled_size
    P, S = int(pooled_size), int(sample_per_part)
    cin = _psroi_channel_index(int(output_dim), int(group_size), P,
                               data.device)
    dt, dev = data.dtype, data.device
    i = torch.arange(P, dtype=dt, device=dev)
    part_i = torch.tensor((np.arange(P) * int(part_size)) // P, device=dev)
    s = torch.arange(S, dtype=dt, device=dev) + 0.5
    outs = []
    for r0 in range(0, rois.shape[0], _ROI_CHUNK):
        roi = rois[r0:r0 + _ROI_CHUNK]
        r = roi.shape[0]
        x1 = torch.round(roi[:, 1]) * spatial_scale - 0.5
        y1 = torch.round(roi[:, 2]) * spatial_scale - 0.5
        x2 = (torch.round(roi[:, 3]) + 1.0) * spatial_scale - 0.5
        y2 = (torch.round(roi[:, 4]) + 1.0) * spatial_scale - 0.5
        rw = torch.clamp(x2 - x1, min=0.1)
        rh = torch.clamp(y2 - y1, min=0.1)
        bh, bw = rh / P, rw / P
        sub_h, sub_w = bh / S, bw / S
        if no_trans or trans is None:
            off_y = torch.zeros((r, P, P), dtype=dt, device=dev)
            off_x = off_y
        else:
            tr = trans[r0:r0 + r][:, :, part_i[:, None], part_i[None, :]]
            off_y = tr[:, 0] * trans_std * rh[:, None, None]
            off_x = tr[:, 1] * trans_std * rw[:, None, None]
        v = (slice(None),) + (None,) * 4
        ys = (y1[v] + i[None, :, None, None, None] * bh[v]
              + s[None, None, None, :, None] * sub_h[v]
              + off_y[:, :, :, None, None])
        xs = (x1[v] + i[None, None, :, None, None] * bw[v]
              + s[None, None, None, None, :] * sub_w[v]
              + off_x[:, :, :, None, None])
        d = data.index_select(0, roi[:, 0].long())
        vals = _bilinear(d, ys, xs)                     # (r, C, P, P, S, S)
        outs.append(_pick_channels(vals.mean((-1, -2)), cin))
    return torch.cat(outs)


# ------------------------------------------------- deformable convolution
@register_op("_contrib_DeformableConvolution",
             aliases=("DeformableConvolution",))
def _deformable_convolution(data, offset, weight, bias=None, *, kernel,
                            stride=None, dilate=None, pad=None,
                            num_filter=None, num_deformable_group=1,
                            num_group=1, no_bias=False, layout=None,
                            workspace=1024):
    """Deformable convolution v1 (reference
    contrib/deformable_convolution.cc): data (B, C, H, W); offset (B,
    2*dg*kh*kw, Ho, Wo), a (dy, dx) pair per tap; weight (O, C, kh, kw).
    A bilinear im2col driven by the offsets (taps outside the map read
    0), then one contraction with the weight."""
    if num_group != 1:
        raise MXNetError("DeformableConvolution: num_group > 1 not supported")
    kh, kw = kernel
    sh, sw = stride if stride else (1, 1)
    dh, dw = dilate if dilate else (1, 1)
    ph, pw = pad if pad else (0, 0)
    B, C, H, W = data.shape
    dg = int(num_deformable_group)
    T = kh * kw
    Ho = (H + 2 * ph - ((kh - 1) * dh + 1)) // sh + 1
    Wo = (W + 2 * pw - ((kw - 1) * dw + 1)) // sw + 1
    dt, dev = data.dtype, data.device
    offs = offset.reshape(B, dg, T, 2, Ho, Wo)
    ky = torch.arange(kh, device=dev).repeat_interleave(kw).to(dt)
    kx = torch.arange(kw, device=dev).repeat(kh).to(dt)
    oy = torch.arange(Ho, dtype=dt, device=dev) * sh - ph
    ox = torch.arange(Wo, dtype=dt, device=dev) * sw - pw
    pos_y = (oy[None, None, None, :, None]
             + (ky * dh)[None, None, :, None, None] + offs[:, :, :, 0])
    pos_x = (ox[None, None, None, None, :]
             + (kx * dw)[None, None, :, None, None] + offs[:, :, :, 1])
    cg = C // dg
    dflat = data.reshape(B, dg, cg, H * W)
    y0 = torch.floor(pos_y)
    x0 = torch.floor(pos_x)
    wy = pos_y - y0
    wx = pos_x - x0
    col = 0.0
    for dy, wy_c in ((0, 1 - wy), (1, wy)):
        for dx, wx_c in ((0, 1 - wx), (1, wx)):
            yc = y0 + dy
            xc = x0 + dx
            ok = (yc >= 0) & (yc < H) & (xc >= 0) & (xc < W)
            idx = (yc.clamp(0, H - 1) * W + xc.clamp(0, W - 1)).long()
            g = torch.gather(dflat, 3, idx.reshape(B, dg, 1, -1)
                             .expand(B, dg, cg, T * Ho * Wo))
            g = g.reshape(B, dg, cg, T, Ho, Wo)
            col = col + g * (wy_c * wx_c * ok.to(dt))[:, :, None]
    wr = weight.reshape(weight.shape[0], dg, cg, T)
    out = torch.einsum("bgcthw,ogct->bohw", col, wr)
    if bias is not None and not no_bias:
        out = out + bias[None, :, None, None]
    return out


# ------------------------------------------------------------ count_sketch
@register_op("_contrib_count_sketch", aliases=("count_sketch",))
def _count_sketch(data, h, s, *, out_dim, processing_batch_size=32):
    """Count-sketch projection (reference contrib/count_sketch.cc):
    out[n, h[i]] += s[i] * data[n, i], as a product with the one-hot
    (in_dim, out_dim) matrix of h."""
    onehot = (h.reshape(-1)[:, None].long() ==
              torch.arange(int(out_dim), device=data.device)[None, :]
              ).to(data.dtype)
    return (data * s.reshape(1, -1)) @ onehot


# ----------------------------------------------------------------- krprod
# the column-wise Khatri-Rao product (reference contrib/krprod.cc) is
# ops/matrix.py's ``khatri_rao``; the contrib name is an alias
alias_op("khatri_rao", "_contrib_krprod")


@register_op("_contrib_bipartite_matching", aliases=("bipartite_matching",),
             num_outputs=2, differentiable=False)
def _bipartite_matching(data, *, threshold, is_ascend=False, topk=-1):
    """Greedy bipartite matching on a score matrix (..., N, M) (reference
    contrib/bounding_box.cc): pairs visited best first (descending, or
    ascending with ``is_ascend``; ties to the lower flat index); a pair
    matches when its row and column are free, its score passes the
    threshold and fewer than ``topk`` matched.  Returns (row -> column
    (..., N), column -> row (..., M)), -1 where unmatched, in data's
    dtype.  One round a match (module note)."""
    shape = data.shape
    n, m = shape[-2], shape[-1]
    flat = data.reshape(-1, n * m)
    nb, dev = flat.shape[0], data.device
    order = torch.sort(flat, dim=1, descending=not is_ascend,
                       stable=True).indices
    sc = torch.gather(flat, 1, order)
    r, c = order // m, order % m
    passes = sc <= threshold if is_ascend else sc >= threshold
    row_m = torch.full((nb, n), -1, dtype=torch.long, device=dev)
    col_m = torch.full((nb, m), -1, dtype=torch.long, device=dev)
    bix = torch.arange(nb, device=dev)
    rounds = min(n, m) if topk < 0 else min(n, m, int(topk))
    for _ in range(rounds):
        free = (torch.gather(row_m, 1, r) < 0) & \
            (torch.gather(col_m, 1, c) < 0) & passes
        any_ = free.any(1)
        first = free.to(torch.uint8).argmax(1)
        rr, cc = r[bix, first], c[bix, first]
        row_m[bix, rr] = torch.where(any_, cc, row_m[bix, rr])
        col_m[bix, cc] = torch.where(any_, rr, col_m[bix, cc])
    return (row_m.reshape(tuple(shape[:-2]) + (n,)).to(data.dtype),
            col_m.reshape(tuple(shape[:-2]) + (m,)).to(data.dtype))
