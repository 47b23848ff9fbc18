"""Published dense peaks of the cards the benchmark knows (NVIDIA's H100
SXM data sheet, without sparsity, at the full 700 W power limit)."""

H100 = {
    "flops": {"bf16": 989e12, "tf32": 495e12, "f32": 67e12, "int8": 1979e12},
    "hbm_bytes_per_s": 3.35e12,
}


def peaks_for(device_name: str):
    """The peak table of a card by its ``torch.cuda.get_device_name``, or
    None for a card the table does not hold (metrics that need it are then
    left out, never guessed)."""
    if "H100" in device_name:
        return H100
    return None


def least_seconds(flops: float, bytes_moved: float, dtype: str, peaks) -> float:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory's rate."""
    return max(flops / peaks["flops"][dtype], bytes_moved / peaks["hbm_bytes_per_s"])
