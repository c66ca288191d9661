"""``api_self_ms``: ms a picture in the API's decode call outside every
span nested in it (stage A; the wait for and the fetch of the picture the
call hands out, which ``OHHandle._wrap`` reads inside the call): NAL split,
headers, RPS and POC, bumping and the hand-off to the pack worker, with the
GIL waits among them.  From the program's spans: ``api_decode``'s self
time."""


def read(ctx):
    a = ctx["spans"].get("api_decode")
    if a is None or "self_s" not in a or not ctx["pictures"]:
        return None
    return a["self_s"] / ctx["pictures"] * 1e3
