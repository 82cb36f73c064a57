"""Model FLOPs of a training step (3 x the forward's convolutions) over the
window's time per step, as a share of the card's published peak in the
configuration's compute dtype (%)."""


def read(record):
    if record.get("kind") != "train" or not record.get("steps"):
        return None
    per_step_s = record["window_s"] / record["steps"]
    return 100.0 * record["step_flops"] / per_step_s / record["peak_flops"]
