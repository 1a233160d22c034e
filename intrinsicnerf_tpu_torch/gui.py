"""Interactive recolouring/relighting GUI over rendered decompositions.

Twin of the repo root's ``gui.py`` for the PyTorch port: a Tkinter app
that loads a render directory's intrinsic decompositions and a saved
cluster palette, lets the user click a pixel to select its (semantic
class, albedo cluster), edit that cluster's colour with RGB sliders or
the HLS hue/saturation picker and lightness slider, toggle the nonlinear
shading/residual transfer curves, scale shading/residual globally, and
save edited frames, the palette, or a recorded video.

All editing logic lives in ``intrinsicnerf_tpu_torch.tools.editing``
(the cluster search on ``device``, default ``"cuda"``); this file is the
Tk view.  ``build_app`` takes the tk / ImageTk modules as parameters so
the widget tree and every callback run without a display in the tests.

Usage:
  python -m intrinsicnerf_tpu_torch.gui \
      --img_dir logs/x/train_render/step_200000 \
      --cluster_config logs/x/train_render/step_200000/cluster [--device cpu]
"""

import argparse
import os


def build_app(img_dir, cluster_config, frame=0, tk=None, ImageTk=None, device="cuda"):
    """Construct the full widget tree + callbacks; returns a handle dict
    (root/session/state + the user-facing callbacks) without entering
    the mainloop.  ``tk``/``ImageTk`` default to the real modules; tests
    inject display-free stubs.  The session's cluster search runs on
    ``device``."""
    if tk is None:
        import tkinter as tk
    if ImageTk is None:
        from PIL import ImageTk

    import numpy as np
    from PIL import Image

    from intrinsicnerf_tpu_torch.tools.editing import EditSession

    session = EditSession(img_dir, cluster_config, device=device)
    frame_ids = session.frame_ids()
    assert frame_ids, f"no albedo_*.png frames in {img_dir}"
    state = {
        "frame": frame if frame in frame_ids else frame_ids[0],
        "selected": None,  # (sem_class, cluster_id)
        "recording": False,
        "frames_out": [],
    }

    root = tk.Tk()
    root.title("IntrinsicNeRF editor (PyTorch)")

    img0 = session.compose(state["frame"])
    h, w = img0.shape[:2]
    scale = max(1, 480 // max(h, w))
    canvas = tk.Canvas(root, width=w * scale, height=h * scale)
    canvas.grid(row=0, column=0, rowspan=12)

    photo = [None]

    def refresh():
        img = session.compose(state["frame"])
        pil = Image.fromarray((img * 255).astype(np.uint8)).resize(
            (w * scale, h * scale), Image.NEAREST
        )
        photo[0] = ImageTk.PhotoImage(pil)
        canvas.create_image(0, 0, image=photo[0], anchor="nw")
        if state["recording"]:
            state["frames_out"].append((img * 255).astype(np.uint8))

    def on_click(event):
        row, col = event.y // scale, event.x // scale
        if 0 <= row < h and 0 <= col < w:
            sem, cid = session.pick(state["frame"], row, col)
            color = session.get_cluster_color(sem, cid)
            state["selected"] = (sem, cid)
            sel_var.set(f"class {sem} / cluster {cid}")
            if color is not None:
                for s, v in zip(sliders, color):
                    s.set(int(v * 255))
                sync_hls_from_rgb(color)

    canvas.bind("<Button-1>", on_click)

    sel_var = tk.StringVar(value="click a pixel")
    tk.Label(root, textvariable=sel_var).grid(row=0, column=1)

    def on_rgb(_=None):
        if state["selected"] is None:
            return
        sem, cid = state["selected"]
        rgb = np.array([s.get() for s in sliders], np.float32) / 255.0
        try:
            session.set_cluster_color(sem, cid, rgb)
        except ValueError:
            return
        refresh()

    sliders = []
    for i, name in enumerate(("R", "G", "B")):
        s = tk.Scale(root, from_=0, to=255, orient="horizontal", label=name,
                     command=on_rgb, length=200)
        s.grid(row=1 + i, column=1)
        sliders.append(s)

    # ---- HLS picker: hue on x, saturation on y (top = 1), lightness on
    # a slider, as the reference draw_color_label/pick_color
    import colorsys

    HLS_W, HLS_H = 180, 120
    hue = np.linspace(0.0, 1.0, HLS_W)
    sat = np.linspace(1.0, 0.0, HLS_H)
    strip = np.empty((HLS_H, HLS_W, 3), np.uint8)
    for yy in range(HLS_H):
        for xx in range(HLS_W):
            r, g, b = colorsys.hls_to_rgb(hue[xx], 0.5, sat[yy])
            strip[yy, xx] = (int(r * 255), int(g * 255), int(b * 255))
    hls_state = {"h": 0.0, "l": 0.5, "s": 1.0}
    hls_canvas = tk.Canvas(root, width=HLS_W, height=HLS_H)
    hls_canvas.grid(row=1, column=2, rowspan=3, padx=6)
    hls_photo = [ImageTk.PhotoImage(Image.fromarray(strip))]
    hls_canvas.create_image(0, 0, image=hls_photo[0], anchor="nw")
    marker = hls_canvas.create_text(0, 0, text="X", fill="white",
                                    state="hidden")

    def apply_hls():
        if state["selected"] is None:
            return
        r, g, b = colorsys.hls_to_rgb(
            hls_state["h"], hls_state["l"], hls_state["s"]
        )
        for s, v in zip(sliders, (r, g, b)):
            s.set(int(v * 255))
        on_rgb()

    def on_hls_click(event):
        xx = min(max(event.x, 0), HLS_W - 1)
        yy = min(max(event.y, 0), HLS_H - 1)
        hls_state["h"] = xx / HLS_W
        hls_state["s"] = (HLS_H - yy) / HLS_H
        hls_canvas.coords(marker, xx, yy)
        hls_canvas.itemconfigure(marker, state="normal")
        apply_hls()

    hls_canvas.bind("<Button-1>", on_hls_click)

    def on_lightness(v):
        hls_state["l"] = float(v) / 255.0
        apply_hls()

    l_slider = tk.Scale(root, from_=0, to=255, orient="horizontal",
                        label="lightness", command=on_lightness, length=180)
    l_slider.grid(row=4, column=2, padx=6)

    def sync_hls_from_rgb(color):
        hh, ll, ss = colorsys.rgb_to_hls(*[float(c) for c in color])
        hls_state.update(h=hh, l=ll, s=ss)
        hls_canvas.coords(
            marker, int(hh * HLS_W), HLS_H - int(ss * HLS_H)
        )
        hls_canvas.itemconfigure(marker, state="normal")
        l_slider.set(int(ll * 255))

    # ---- nonlinear transfer toggles (reference f_shading/f_residual)
    def toggle_shading_transfer():
        session.shading_transfer = not session.shading_transfer
        refresh()

    def toggle_residual_transfer():
        session.residual_transfer = not session.residual_transfer
        refresh()

    tk.Checkbutton(root, text="shading s^2 transfer",
                   command=toggle_shading_transfer).grid(row=5, column=2)
    tk.Checkbutton(root, text="residual sine transfer",
                   command=toggle_residual_transfer).grid(row=6, column=2)

    def on_shading(v):
        session.shading_scale = float(v)
        refresh()

    def on_residual(v):
        session.residual_scale = float(v)
        refresh()

    def on_gamma(v):
        session.shading_gamma = float(v)
        refresh()

    tk.Scale(root, from_=0.0, to=3.0, resolution=0.05, orient="horizontal",
             label="shading scale", command=on_shading, length=200).grid(
        row=4, column=1)
    tk.Scale(root, from_=0.0, to=3.0, resolution=0.05, orient="horizontal",
             label="residual scale", command=on_residual, length=200).grid(
        row=5, column=1)
    tk.Scale(root, from_=0.2, to=3.0, resolution=0.05, orient="horizontal",
             label="shading gamma", command=on_gamma, length=200).grid(
        row=6, column=1)

    def next_frame():
        i = frame_ids.index(state["frame"])
        state["frame"] = frame_ids[(i + 1) % len(frame_ids)]
        refresh()

    def save_frame():
        out = os.path.join(img_dir, f"edited_{state['frame']:03d}.png")
        session.save_edit(state["frame"], out)
        sel_var.set(f"saved {out}")

    def save_palette():
        out = os.path.join(img_dir, "edited_cluster")
        session.save_palette(out)
        sel_var.set(f"palette -> {out}")

    def toggle_record():
        if state["recording"]:
            state["recording"] = False
            if state["frames_out"]:
                from intrinsicnerf_tpu_torch.tools.video import write_video

                out = os.path.join(img_dir, "edit_session.mp4")
                write_video(out, state["frames_out"], fps=10)
                sel_var.set(f"video -> {out}")
            state["frames_out"] = []
            rec_btn.config(text="record")
        else:
            state["recording"] = True
            rec_btn.config(text="stop rec")

    tk.Button(root, text="next frame", command=next_frame).grid(row=7, column=1)
    tk.Button(root, text="save edit", command=save_frame).grid(row=8, column=1)
    tk.Button(root, text="save palette", command=save_palette).grid(row=9, column=1)
    tk.Button(root, text="reset palette",
              command=lambda: (session.reset_palette(), refresh())).grid(
        row=10, column=1)
    rec_btn = tk.Button(root, text="record", command=toggle_record)
    rec_btn.grid(row=11, column=1)

    refresh()
    return {
        "root": root,
        "session": session,
        "state": state,
        "sliders": sliders,
        "sel_var": sel_var,
        "refresh": refresh,
        "on_click": on_click,
        "on_rgb": on_rgb,
        "on_hls_click": on_hls_click,
        "on_lightness": on_lightness,
        "next_frame": next_frame,
        "save_frame": save_frame,
        "save_palette": save_palette,
        "toggle_record": toggle_record,
        "toggle_shading_transfer": toggle_shading_transfer,
        "toggle_residual_transfer": toggle_residual_transfer,
        "on_shading": on_shading,
        "on_residual": on_residual,
        "on_gamma": on_gamma,
    }


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--img_dir", required=True)
    parser.add_argument("--cluster_config", required=True)
    parser.add_argument("--frame", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="the cluster search's device")
    args = parser.parse_args()

    app = build_app(args.img_dir, args.cluster_config, frame=args.frame, device=args.device)
    app["root"].mainloop()


if __name__ == "__main__":
    main()
