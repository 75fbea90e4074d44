"""Indoor 3D detection mAP/mAR evaluation (host-side NumPy), the port's copy
of sgcdet_tpu/eval/indoor_eval.py: mmdet3d's indoor protocol, per-class
greedy matching of confidence-sorted detections against GT at several IoU
thresholds and VOC-style area AP.

Boxes are :class:`sgcdet_tpu_torch.geometry.boxes.DepthBoxes3D`.
"""
from __future__ import annotations

import numpy as np

from ..geometry.boxes import DepthBoxes3D


def average_precision(recalls, precisions, mode="area"):
    """VOC AP from recall/precision curves."""
    if recalls.ndim == 1:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                prec = precs.max() if precs.size > 0 else 0
                ap[i] += prec
            ap /= 11
    else:
        raise ValueError('mode must be "area" or "11points"')
    return ap


def eval_det_cls(pred, gt, iou_thr):
    """Precision/recall/AP for one class.

    Args:
      pred: {img_id: [(DepthBoxes3D row, score), ...]}
      gt: {img_id: [DepthBoxes3D row, ...]}
      iou_thr: list of IoU thresholds.

    Returns list of (recall, precision, ap) per threshold (greedy best-IoU
    matching in confidence order).
    """
    class_recs = {}
    npos = 0
    for img_id in gt.keys():
        boxes = gt[img_id]
        if len(boxes) != 0:
            stacked = np.concatenate([b.tensor for b in boxes], axis=0)
            bbox = boxes[0].new_box(stacked)
        else:
            bbox = boxes
        det = [[False] * len(bbox) for _ in iou_thr]
        npos += len(bbox)
        class_recs[img_id] = {"bbox": bbox, "det": det}

    image_ids = []
    confidence = []
    ious = []
    for img_id in pred.keys():
        cur_num = len(pred[img_id])
        if cur_num == 0:
            continue
        boxes = []
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            boxes.append(box.tensor)
        pred_cur = pred[img_id][0][0].new_box(np.concatenate(boxes, axis=0))
        gt_cur = class_recs[img_id]["bbox"]
        if len(gt_cur) > 0:
            iou_cur = DepthBoxes3D.overlaps(pred_cur, gt_cur)
            for i in range(cur_num):
                ious.append(iou_cur[i])
        else:
            for _ in range(cur_num):
                ious.append(np.zeros(1))

    confidence = np.asarray(confidence)
    sorted_ind = np.argsort(-confidence)
    image_ids = [image_ids[x] for x in sorted_ind]
    ious = [ious[x] for x in sorted_ind]

    nd = len(image_ids)
    tp_thr = [np.zeros(nd) for _ in iou_thr]
    fp_thr = [np.zeros(nd) for _ in iou_thr]
    for d in range(nd):
        rec = class_recs[image_ids[d]]
        iou_max = -np.inf
        bbgt = rec["bbox"]
        cur_iou = ious[d]
        jmax = -1
        if len(bbgt) > 0:
            for j in range(len(bbgt)):
                iou = cur_iou[j]
                if iou > iou_max:
                    iou_max = iou
                    jmax = j
        for iou_idx, thresh in enumerate(iou_thr):
            if iou_max > thresh:
                if not rec["det"][iou_idx][jmax]:
                    tp_thr[iou_idx][d] = 1.0
                    rec["det"][iou_idx][jmax] = True
                else:
                    fp_thr[iou_idx][d] = 1.0
            else:
                fp_thr[iou_idx][d] = 1.0

    ret = []
    for iou_idx, _ in enumerate(iou_thr):
        fp = np.cumsum(fp_thr[iou_idx])
        tp = np.cumsum(tp_thr[iou_idx])
        recall = tp / float(max(npos, 1))
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        ap = average_precision(recall, precision)
        ret.append((recall, precision, ap))
    return ret


def eval_map_recall(pred, gt, ovthresh):
    """Multi-class AP/recall."""
    ret_values = {}
    for classname in gt.keys():
        if classname in pred:
            ret_values[classname] = eval_det_cls(pred[classname], gt[classname], ovthresh)
    recall = [{} for _ in ovthresh]
    precision = [{} for _ in ovthresh]
    ap = [{} for _ in ovthresh]
    for label in gt.keys():
        for iou_idx, _ in enumerate(ovthresh):
            if label in pred:
                recall[iou_idx][label], precision[iou_idx][label], ap[iou_idx][label] = (
                    ret_values[label][iou_idx]
                )
            else:
                recall[iou_idx][label] = np.zeros(1)
                precision[iou_idx][label] = np.zeros(1)
                ap[iou_idx][label] = np.zeros(1)
    return recall, precision, ap


def indoor_eval(gt_annos, dt_annos, metric, label2cat, logger=None):
    """End-to-end indoor eval.

    Args:
      gt_annos: list of dicts with 'gt_num', 'gt_boxes_upright_depth' (k, 6/7)
        with gravity-center origin, and 'class' (k,) labels.
      dt_annos: list of dicts with 'boxes_3d' (DepthBoxes3D), 'scores_3d',
        'labels_3d' (NumPy arrays).
      metric: list of IoU thresholds, e.g. [0.25, 0.5].
      label2cat: {label: name}.

    Returns dict with per-class AP/recall and mAP_/mAR_ entries; prints a
    per-class table.
    """
    assert len(dt_annos) == len(gt_annos)
    pred = {}
    gt = {}
    for img_id in range(len(dt_annos)):
        det_anno = dt_annos[img_id]
        labels_3d = np.asarray(det_anno["labels_3d"])
        scores_3d = np.asarray(det_anno["scores_3d"])
        boxes_3d = det_anno["boxes_3d"]
        for i in range(len(labels_3d)):
            label = int(labels_3d[i])
            pred.setdefault(label, {}).setdefault(img_id, [])
            gt.setdefault(label, {}).setdefault(img_id, [])
            pred[label][img_id].append((boxes_3d[i], float(scores_3d[i])))

        gt_anno = gt_annos[img_id]
        if gt_anno["gt_num"] != 0:
            gt_boxes = DepthBoxes3D(
                gt_anno["gt_boxes_upright_depth"],
                box_dim=gt_anno["gt_boxes_upright_depth"].shape[-1],
                origin=(0.5, 0.5, 0.5),
                with_yaw=gt_anno["gt_boxes_upright_depth"].shape[-1] == 7,
            )
            labels = gt_anno["class"]
        else:
            gt_boxes = DepthBoxes3D(np.zeros((0, 7), np.float32))
            labels = np.array([], np.int64)
        for i in range(len(labels)):
            label = int(labels[i])
            gt.setdefault(label, {}).setdefault(img_id, [])
            gt[label][img_id].append(gt_boxes[i])

    rec, prec, ap = eval_map_recall(pred, gt, metric)
    ret_dict = {}
    rows = []
    for i, iou_thresh in enumerate(metric):
        for label in ap[i].keys():
            ret_dict[f"{label2cat[label]}_AP_{iou_thresh:.2f}"] = float(ap[i][label][0])
        ret_dict[f"mAP_{iou_thresh:.2f}"] = float(np.mean(list(ap[i].values())))
        rec_list = []
        for label in rec[i].keys():
            ret_dict[f"{label2cat[label]}_rec_{iou_thresh:.2f}"] = float(rec[i][label][-1])
            rec_list.append(rec[i][label][-1])
        ret_dict[f"mAR_{iou_thresh:.2f}"] = float(np.mean(rec_list))

    # plain-text per-class report
    header = ["classes"]
    for t in metric:
        header += [f"AP_{t:.2f}", f"AR_{t:.2f}"]
    rows.append("\t".join(header))
    for label in ap[0].keys():
        cells = [str(label2cat[label])]
        for i, t in enumerate(metric):
            cells.append(f"{float(ap[i][label][0]):.4f}")
            cells.append(f"{float(rec[i][label][-1]):.4f}")
        rows.append("\t".join(cells))
    overall = ["Overall"]
    for t in metric:
        overall += [f"{ret_dict[f'mAP_{t:.2f}']:.4f}", f"{ret_dict[f'mAR_{t:.2f}']:.4f}"]
    rows.append("\t".join(overall))
    report = "\n".join(rows)
    if logger is not None:
        logger.info("\n" + report)
    else:
        print(report)
    return ret_dict
