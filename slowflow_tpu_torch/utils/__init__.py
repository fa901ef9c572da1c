"""Host-side helpers of the CLIs: demosaicing, the flow colour wheel,
flow accuracy metrics."""
