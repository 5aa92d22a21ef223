"""The (data, model) mesh as torch.distributed process groups, tensor
parallelism of the policy trunk, and the launcher of local ranks."""
