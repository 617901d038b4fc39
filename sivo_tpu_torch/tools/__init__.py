"""Offline tools of the port: ``train_bench_segnet`` (SegNet basic
trained on the bench loop world) and ``train_offline_vocab`` (the ORB
vocabulary trained on worlds disjoint from the bench), each run as
``python -m sivo_tpu_torch.tools.<name>``."""
