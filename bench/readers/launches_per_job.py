"""Kernel layer: kernel launches per job over the window, from the port's
launch counters (`repro_torch.kernels.launch_counts`, counted after a
launch succeeded)."""


def read(rec):
    if rec["kind"] != "cnn" or not rec["jobs"]:
        return None
    return sum(rec["launches"].values()) / rec["jobs"]
