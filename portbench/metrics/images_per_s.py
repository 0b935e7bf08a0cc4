"""Images whose logits came back, over all the seconds of the window."""


def read(rec):
    w = rec["window"]
    if "images" not in w or w["seconds"] <= 0:
        return None
    return w["images"] / w["seconds"]
