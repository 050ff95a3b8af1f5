"""Model families: one file a family, found by the family's name
(`cells.family`), holding what the harness needs of it: its weight
layout, its attention layers' windows, its FLOPs, and its plain
references for serving and training."""
