"""Placement rules over a ``torch.distributed`` device mesh: logical axes
to DTensor placements (``specs``), and the FL state and batch trees
(``fl_specs``)."""
