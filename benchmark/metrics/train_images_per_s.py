"""Images of every training step finished in the window (the card
synchronised at its end), over the window's seconds."""


def read(ctx):
    w = ctx["window"]
    return w["images"] / w["seconds"] if "images" in w else None
