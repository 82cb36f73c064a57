"""The forward's model FLOPs (its convolutions) of every batch over the
window, as a share of the card's published peak in the compute dtype (%)."""


def read(record):
    if record.get("kind") != "detect" or not record.get("batches"):
        return None
    rate = record["batch_flops"] * record["batches"] / record["window_s"]
    return 100.0 * rate / record["peak_flops"]
