"""Example train loops (``python -m ray_tpu_torch.examples.train_llama_dp``)."""
