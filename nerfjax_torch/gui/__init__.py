"""GUI front-ends of the port (counterpart of ``nerfjax/gui``).

The three GUI tools (``final_gui``, ``run_gui``, ``open3d_gui``) on tkinter
+ matplotlib, with the same three capabilities as nerfjax's: config
creation, pipeline launching (the port's CLIs, on the card by default),
volume viewing; ``viewers`` holds the point-cloud previews the CLIs show.
All non-widget logic lives in ``nerfjax_torch.gui.logic`` and is tested.
"""
