"""Interval algebra for diarization results (host-side functions).

A copy of targetdiarization_tpu/pipeline/intervals.py, which the port
does not import: IoU scoring, greedy speaker-key matching, merge and
subtract, overlap regions and overlap maps. Two quirks of the reference
system are fixed there and here alike: subtracting nothing returns the
base unchanged, and `calc_iou_score` counts each inside interval's IoU
once, length-weighted, less the penalty of negative regions, clamped to
[0, 1].

A diarization result ("sd_result") is {speaker_label: [(start, end), ...]}
in seconds; an overlap result ("od_result") is {"a-b": [(start, end), ...]}
keyed by speaker pairs.
"""

from __future__ import annotations

from itertools import combinations


def merge_timeranges(timeranges: list) -> list:
    """[(1,3),(2,6),(8,10),(10,11)] → [(1,6),(8,11)]."""
    if not timeranges:
        return []
    ordered = sorted(timeranges, key=lambda x: x[0])
    merged = [tuple(ordered[0])]
    for start, end in ordered[1:]:
        last_start, last_end = merged[-1]
        if start <= last_end:
            merged[-1] = (last_start, max(last_end, end))
        else:
            merged.append((start, end))
    return merged


def subtract_timeranges(base: list, sub: list) -> list:
    """[(0,10)] − [(3,5)] → [(0,3),(5,10)]."""
    if not sub:
        return list(base)
    sub = merge_timeranges(sub)
    out = []
    for b_start, b_end in base:
        cursor = b_start
        for s_start, s_end in sub:
            if cursor >= s_end:
                continue
            if b_end <= s_start:
                break
            o_start, o_end = max(cursor, s_start), min(b_end, s_end)
            if o_start < o_end:
                if o_start > cursor:
                    out.append((cursor, o_start))
                cursor = o_end
        if cursor < b_end:
            out.append((cursor, b_end))
    return out


def total_duration(timeranges: list) -> float:
    return sum(e - s for s, e in timeranges)


def calc_single_iou(a, b) -> float:
    """IoU of two intervals (order-normalized)."""
    a = sorted(a[:2])
    b = sorted(b[:2])
    inter = min(a[1], b[1]) - max(a[0], b[0])
    if inter <= 0:
        return 0.0
    union = max(a[1], b[1]) - min(a[0], b[0])
    return inter / union


def calc_multi_iou(preds: list, gts: list, method: str = "both_mean") -> float:
    """Mean best-match IoU between two interval sets; `method` selects
    pred→gt, gt→pred, or their average (reference :268-299)."""
    if not preds or not gts:
        raise ValueError("interval sets cannot be empty")
    p2g = sum(max(calc_single_iou(p, g) for g in gts) for p in preds) / len(preds)
    g2p = sum(max(calc_single_iou(g, p) for p in preds) for g in gts) / len(gts)
    if method == "pred_to_gt":
        return p2g
    if method == "gt_to_pred":
        return g2p
    return (p2g + g2p) / 2.0


def calc_iou_score(
    preds: list, gts: list, positive_weight: float = 1.0, negative_weight: float = 1.0
) -> float:
    """Coverage score in [0,1]: how well `preds` matches `gts`, rewarding
    in-gt overlap (length-weighted IoU) and punishing prediction mass
    outside the gt regions (reference :302-362, cleaned)."""
    if not preds or not gts:
        raise ValueError("interval sets cannot be empty")
    gts_m = merge_timeranges(gts)
    inside, outside = [], []
    for p in preds:
        p_in = subtract_timeranges([p], subtract_timeranges([p], gts_m))
        inside.extend(p_in)
        outside.extend(subtract_timeranges([p], gts_m))
    total_in = total_duration(inside)
    positive = 0.0
    if total_in > 0:
        for seg in inside:
            w = (seg[1] - seg[0]) / total_in
            positive += w * calc_multi_iou([seg], gts, method="pred_to_gt")
    gt_sum = total_duration(gts_m)
    negative = total_duration(outside) / gt_sum if gt_sum > 0 else 0.0
    score = positive * positive_weight - negative * negative_weight
    if positive_weight == 0.0:
        score = abs(score)
    return max(0.0, min(score, 1.0))


def sd_key_matcher(source_sd: dict, target_sd: dict) -> dict:
    """Relabel `target_sd` keys to the best-matching `source_sd` keys
    (greedy, one-to-one, by IoU score — reference :365-392). Unmatched
    target keys keep their labels."""
    mapper = {}
    taken = set()
    for src_spk, src_ranges in source_sd.items():
        best, best_score = None, 0.0
        for tgt_spk, tgt_ranges in target_sd.items():
            if tgt_spk in taken or not src_ranges or not tgt_ranges:
                continue
            score = calc_iou_score(src_ranges, tgt_ranges)
            if score > best_score:
                best, best_score = tgt_spk, score
        if best is not None:
            mapper[best] = src_spk
            taken.add(best)
    if not mapper:
        return target_sd
    out = {}
    for tgt_spk, src_spk in mapper.items():
        out[src_spk] = target_sd[tgt_spk]
    for tgt_spk, ranges in target_sd.items():
        if tgt_spk not in mapper and tgt_spk not in out:
            out[tgt_spk] = ranges
    return out


def get_speaker_overlap(result: dict, min_overlap_sec: float = 0.4) -> dict:
    """Pairwise overlapping regions ≥ min_overlap_sec:
    {'a-b': [(s,e), ...]} (reference :521-548)."""
    overlap = {}
    for (spk_a, ranges_a), (spk_b, ranges_b) in combinations(result.items(), 2):
        found = []
        for s1, e1 in ranges_a:
            for s2, e2 in ranges_b:
                o_s, o_e = max(s1, s2), min(e1, e2)
                if o_s < o_e and (o_e - o_s) >= min_overlap_sec:
                    found.append((o_s, o_e))
        if found:
            overlap[f"{spk_a}-{spk_b}"] = found
    return overlap


def apply_od_result(sd_result: dict, od_result: dict | None = None):
    """Refine a diarization result with overlap regions.

    Overlap regions are assigned to BOTH speakers of each pair and the
    single-speaker remainder is the original timeline minus all overlap
    (reference :433-472). Returns (refined_result, overlap_map) where
    overlap_map is [[(spk, idx_into_refined[spk]), ...], ...] — one entry
    per overlap region listing which (speaker, segment-index) pairs are
    that region.
    """
    if not od_result:
        return sd_result, []
    # normalize: key order ('2-0' ≡ '0-2') and overlapping ranges within
    # one pair collapse — multi-slot segmentation can emit two near-equal
    # regions for the same speaker pair, which otherwise become duplicate
    # overlap segments in the final result
    normalized: dict = {}
    for pair_key, ranges in od_result.items():
        key = "-".join(sorted(pair_key.split("-")))
        normalized.setdefault(key, []).extend(ranges)
    od_result = {
        k: [tuple(r) for r in merge_timeranges(sorted(v))]
        for k, v in normalized.items()
    }
    refined: dict = {}
    overlap_regions: list = []
    all_overlap: list = []
    for ranges in od_result.values():
        all_overlap.extend(ranges)
    all_overlap = merge_timeranges(all_overlap)
    for pair_key, ranges in od_result.items():
        for spk in pair_key.split("-"):
            refined.setdefault(spk, []).extend(ranges)
        for r in ranges:
            if r not in overlap_regions:
                overlap_regions.append(r)
    for spk, ranges in sd_result.items():
        if not ranges:
            continue
        refined.setdefault(spk, [])
        refined[spk].extend(subtract_timeranges(ranges, all_overlap))
    for spk in refined:
        refined[spk] = sorted(set(refined[spk]), key=lambda x: x[0])
    overlap_map = []
    for region in overlap_regions:
        entry = [
            (spk, i)
            for spk, ranges in refined.items()
            for i in range(len(ranges))
            if ranges[i] == region
        ]
        if entry:
            overlap_map.append(entry)
    return refined, overlap_map


def subtract_overlap(sd_result: dict, overlap_map: list | None = None,
                     reverse_output: bool = False) -> dict:
    """Drop (or keep only, with reverse_output) the segments referenced
    by overlap_map (reference :475-493)."""
    if not overlap_map:
        return sd_result
    flagged = {spk: set() for spk in sd_result}
    for entry in overlap_map:
        for spk, idx in entry:
            if spk in flagged:
                flagged[spk].add(idx)
    out = {}
    for spk, ranges in sd_result.items():
        keep = [
            r
            for i, r in enumerate(ranges)
            if (i in flagged[spk]) == reverse_output
        ]
        out[spk] = keep
    return out


def get_speaker_num(result: dict, threshold: float = 0.0) -> int:
    """Speaker count; with threshold > 0 a non-main speaker only counts
    if one of its segments exceeds threshold seconds (reference :496-518)."""
    if len(result) <= 1 or threshold <= 0:
        return len(result)
    main_spk = max(result, key=lambda s: total_duration(result[s]))
    count = 0
    for spk, ranges in result.items():
        if spk == main_spk or any((e - s) > threshold for s, e in ranges):
            count += 1
    return count


def parse_segments(segments: list, is_single: bool = False,
                   combine: bool = False) -> dict:
    """[[start, end, spk], ...] → sd_result dict; with combine=True,
    consecutive same-speaker segments are joined (reference
    sd_result_parser :185-225)."""
    result: dict = {}
    if not segments:
        return result
    ordered = sorted(segments, key=lambda x: x[0])
    runs = []
    for start, end, spk in ordered:
        label = "0" if is_single else str(int(spk))
        if combine and runs and runs[-1][2] == label:
            runs[-1][1] = end
        else:
            runs.append([start, end, label])
    for start, end, label in runs:
        result.setdefault(label, []).append((round(start, 3), round(end, 3)))
    if is_single and result:
        result["0"] = merge_timeranges(result["0"])
    return result
