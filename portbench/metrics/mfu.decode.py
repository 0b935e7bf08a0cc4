"""The dense network's model FLOPs a token (2 a multiply-add at the
published widths) times the window's served tokens a second, over the
card's float32 peak (the precision the tables are summed in)."""


def read(rec):
    p, w = rec.get("peaks"), rec["window"]
    if not p or "tokens" not in w or w["seconds"] <= 0:
        return None
    rate = w["tokens"] / w["seconds"]
    return 100.0 * rec["work"]["token_flops"] * rate / p["float32_ops_per_s"]
