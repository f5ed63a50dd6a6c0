"""Seconds of the index's cuckoo table build (the program's
index.cuckoo_build span, the recorder's total over the process: the warm
call's build in set-up; the window reuses the table)."""


def read(ctx):
    from gdiet_tpu_torch.utils import profile

    ns = getattr(getattr(profile, "PROFILE", None), "ns", {}).get("index.cuckoo_build")
    return ns / 1e9 if ns else None
