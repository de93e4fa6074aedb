"""Offline preprocessing of a scene (the port of localrf_tpu/preprocess/):
RAFT optical flow into flow_ds/ and flow_vis/ (`python -m
localrf_tpu_torch.preprocess.run_flow`), DPT inverse depth into depth/
(`python -m localrf_tpu_torch.preprocess.run_depth`)."""
