from .rpn import StandardRPNHead, find_top_rpn_proposals, rpn_losses, subsample_labels, top_k_indices

__all__ = ["StandardRPNHead", "find_top_rpn_proposals", "rpn_losses", "subsample_labels", "top_k_indices"]
