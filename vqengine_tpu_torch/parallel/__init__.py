"""Multi-GPU rendering on torch.distributed: dp x sp screen bands
(multichip.py) and the launcher of their ranks (launch.py)."""
