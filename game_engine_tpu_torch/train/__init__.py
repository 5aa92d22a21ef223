"""PPO training of the policy net in the PyTorch port."""
