"""Interactive 3D map viewer: one self-contained HTML file, no deps (port of
``vo_slam_test_tpu/viz/webviewer.py``; numpy and json, so the page is
byte-equal to the JAX package's for the same snapshot).

The reference Drawer runs a live Pangolin window (drawer.cpp:55-366): 3D
map points, keyframe frusta, covisibility (green) / spanning-tree (red) /
loop (blue) edges, follow-camera, and a pose readout panel. This module
exports the same drawable content (a MapSnapshot plus the per-frame
trajectory) into a single HTML file with an embedded vanilla-JS canvas
renderer:

  - orbit (drag), pan (right-drag / shift-drag), zoom (wheel);
  - map points (black, local points red — drawer.cpp:140-178 colors);
  - keyframe frusta with covis/tree/loop edges in the reference colors;
  - trajectory playback with a follow-camera toggle (drawer.cpp:181-223)
    and a live pose readout panel (:225-252).

Everything is inlined: open the file in any browser, offline.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .drawer import MapSnapshot, _centers

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>vo_slam_test_tpu map viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:12px monospace; overflow:hidden; }
 #hud { position:fixed; top:8px; left:8px; background:rgba(0,0,0,.6);
        padding:8px 10px; border-radius:4px; white-space:pre; }
 #bar { position:fixed; bottom:8px; left:8px; right:8px; display:flex;
        gap:8px; align-items:center; }
 button { background:#333; color:#ddd; border:1px solid #555; padding:4px 10px;
          border-radius:3px; cursor:pointer; }
 input[type=range] { flex:1; }
 canvas { display:block; }
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar">
 <button id="play">play</button>
 <label><input type="checkbox" id="follow"> follow</label>
 <input type="range" id="seek" min="0" value="0" step="1">
</div>
<script>
const DATA = __DATA__;
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let W, H; function resize(){ W=cv.width=innerWidth; H=cv.height=innerHeight; draw(); }
addEventListener("resize", resize);

// orbit-camera state: target + yaw/pitch/dist (world y-down, like the map)
let yaw=-0.6, pitch=0.45, dist=8, tgt=[0,0,2];
let frame = DATA.traj.length ? DATA.traj.length-1 : 0, playing=false, follow=false;

function camBasis(){
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  // right, up, forward of the orbit camera
  const f=[ sy*cp, -sp, cy*cp ];
  const r=[ cy, 0, -sy ];
  const u=[ sy*sp, cp, cy*sp ];
  const eye=[ tgt[0]-f[0]*dist, tgt[1]-f[1]*dist, tgt[2]-f[2]*dist ];
  return {r,u,f,eye};
}
function project(p, B){
  const d=[p[0]-B.eye[0], p[1]-B.eye[1], p[2]-B.eye[2]];
  const z=d[0]*B.f[0]+d[1]*B.f[1]+d[2]*B.f[2];
  if (z<0.05) return null;
  const x=d[0]*B.r[0]+d[1]*B.r[1]+d[2]*B.r[2];
  const y=d[0]*B.u[0]+d[1]*B.u[1]+d[2]*B.u[2];
  const s=0.9*Math.min(W,H);
  return [W/2 + s*x/z, H/2 - s*y/z, z];
}
function kfCenter(T){ // T = T_c_w rows; center = -R^T t
  const R=[[T[0][0],T[0][1],T[0][2]],[T[1][0],T[1][1],T[1][2]],[T[2][0],T[2][1],T[2][2]]];
  const t=[T[0][3],T[1][3],T[2][3]];
  return [-(R[0][0]*t[0]+R[1][0]*t[1]+R[2][0]*t[2]),
          -(R[0][1]*t[0]+R[1][1]*t[1]+R[2][1]*t[2]),
          -(R[0][2]*t[0]+R[1][2]*t[1]+R[2][2]*t[2])];
}
function frustum(T, sc){ // 5 world-space corners of a camera wedge
  const R=[[T[0][0],T[0][1],T[0][2]],[T[1][0],T[1][1],T[1][2]],[T[2][0],T[2][1],T[2][2]]];
  const c=kfCenter(T), out=[c];
  for (const [x,y] of [[-1,-0.75],[1,-0.75],[1,0.75],[-1,0.75]]){
    const pc=[x*sc, y*sc, 1.6*sc];       // camera-frame corner
    out.push([c[0]+R[0][0]*pc[0]+R[1][0]*pc[1]+R[2][0]*pc[2],
              c[1]+R[0][1]*pc[0]+R[1][1]*pc[1]+R[2][1]*pc[2],
              c[2]+R[0][2]*pc[0]+R[1][2]*pc[1]+R[2][2]*pc[2]]);
  }
  return out;
}
function line(a, b, B, color, w){
  const pa=project(a,B), pb=project(b,B);
  if (!pa||!pb) return;
  ctx.strokeStyle=color; ctx.lineWidth=w;
  ctx.beginPath(); ctx.moveTo(pa[0],pa[1]); ctx.lineTo(pb[0],pb[1]); ctx.stroke();
}
function draw(){
  if (follow && DATA.traj.length){
    const c=kfCenter(DATA.traj[frame]); tgt=[c[0],c[1],c[2]];
  }
  const B=camBasis();
  ctx.fillStyle="#111"; ctx.fillRect(0,0,W,H);
  // map points: black(=gray here) / local red (drawer.cpp:140-178)
  for (let i=0;i<DATA.pts.length;i++){
    const pr=project(DATA.pts[i],B);
    if (!pr) continue;
    ctx.fillStyle = DATA.local[i] ? "#e33" : "#aaa";
    ctx.fillRect(pr[0], pr[1], 1.5, 1.5);
  }
  const ctr = DATA.kf.map(kfCenter);
  for (const [a,b] of DATA.covis) line(ctr[a], ctr[b], B, "rgba(0,200,0,.45)", 0.7);
  for (const [a,b] of DATA.tree)  line(ctr[a], ctr[b], B, "#d44", 1.2);
  for (const [a,b] of DATA.loop)  line(ctr[a], ctr[b], B, "#48f", 2.0);
  for (const T of DATA.kf){
    const f=frustum(T, 0.06);
    for (let i=1;i<=4;i++){ line(f[0],f[i],B,"#6af",0.8); line(f[i],f[i%4+1],B,"#6af",0.8); }
  }
  // trajectory up to the playback cursor + current camera in green
  for (let i=1;i<=frame && i<DATA.traj.length;i++)
    line(kfCenter(DATA.traj[i-1]), kfCenter(DATA.traj[i]), B, "#dd4", 1.4);
  if (DATA.traj.length){
    const f=frustum(DATA.traj[frame], 0.1);
    for (let i=1;i<=4;i++){ line(f[0],f[i],B,"#3e3",1.6); line(f[i],f[i%4+1],B,"#3e3",1.6); }
  }
  // pose readout (drawer.cpp:225-252)
  let hud = `keyframes ${DATA.kf.length}  points ${DATA.pts.length}` +
            `  loop edges ${DATA.loop.length}`;
  if (DATA.traj.length){
    const c=kfCenter(DATA.traj[frame]);
    hud += `\\nframe ${frame}/${DATA.traj.length-1}` +
           `\\nx ${c[0].toFixed(3)}  y ${c[1].toFixed(3)}  z ${c[2].toFixed(3)}`;
  }
  document.getElementById("hud").textContent = hud;
}
// interaction
let drag=null;
cv.onmousedown = e => drag=[e.clientX,e.clientY,e.button===2||e.shiftKey];
addEventListener("mouseup", ()=>drag=null);
addEventListener("mousemove", e=>{
  if (!drag) return;
  const dx=e.clientX-drag[0], dy=e.clientY-drag[1];
  if (drag[2]){ // pan in the view plane
    const B=camBasis(), s=dist/600;
    tgt=[tgt[0]-(B.r[0]*dx-B.u[0]*dy)*s, tgt[1]-(B.r[1]*dx-B.u[1]*dy)*s,
         tgt[2]-(B.r[2]*dx-B.u[2]*dy)*s];
  } else { yaw+=dx*0.008; pitch=Math.max(-1.55,Math.min(1.55,pitch+dy*0.008)); }
  drag=[e.clientX,e.clientY,drag[2]]; draw();
});
cv.oncontextmenu = e => e.preventDefault();
addEventListener("wheel", e=>{ dist*=Math.exp(e.deltaY*0.001); draw(); });
const seek=document.getElementById("seek");
seek.max=Math.max(DATA.traj.length-1,0); seek.value=frame;
seek.oninput = ()=>{ frame=+seek.value; draw(); };
document.getElementById("follow").onchange = e=>{ follow=e.target.checked; draw(); };
document.getElementById("play").onclick = function(){
  playing=!playing; this.textContent=playing?"pause":"play";
  if (playing && frame>=DATA.traj.length-1) frame=0;
  (function tick(){
    if (!playing) return;
    frame=Math.min(frame+1, DATA.traj.length-1); seek.value=frame; draw();
    if (frame<DATA.traj.length-1) setTimeout(tick, 40);
    else { playing=false; document.getElementById("play").textContent="play"; }
  })();
};
resize();
</script></body></html>
"""


def export_html(
    snap: MapSnapshot,
    path: str,
    traj_T_w_c: np.ndarray | None = None,
    local_mask: np.ndarray | None = None,
    max_points: int = 60000,
    autorefresh_s: float | None = None,
) -> None:
    """Write the interactive viewer HTML for a map snapshot.

    traj_T_w_c: optional [F,4,4] camera-to-world per-frame poses (the
    convention results() returns) for playback/follow-cam.
    local_mask: optional [P] bool over snap.points — drawn red (the
    reference's local-map point coloring, drawer.cpp:155-166).
    autorefresh_s: live mode (run_slam --viewer-live) — the page reloads
    itself every N seconds so a browser tracks the growing map."""
    pts = np.asarray(snap.points, np.float64)
    if local_mask is None:
        local_mask = np.zeros(len(pts), bool)
    local_mask = np.asarray(local_mask, bool)
    if len(pts) > max_points:  # keep the file and redraw cost bounded
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts, local_mask = pts[sel], local_mask[sel]
    if traj_T_w_c is None or len(traj_T_w_c) == 0:
        traj = np.zeros((0, 4, 4))
    else:  # the JS renderer consumes T_c_w (same convention as kf_poses)
        Twc = np.asarray(traj_T_w_c, np.float64)
        R, t = Twc[:, :3, :3], Twc[:, :3, 3]
        traj = np.tile(np.eye(4), (len(Twc), 1, 1))
        traj[:, :3, :3] = np.swapaxes(R, 1, 2)
        traj[:, :3, 3] = -np.einsum("fji,fj->fi", R, t)
    rnd = lambda a, n: np.round(np.asarray(a, np.float64), n).tolist()
    data = {
        "pts": rnd(pts, 3),
        "local": local_mask.astype(int).tolist(),
        "kf": rnd(snap.kf_poses, 4),
        "covis": snap.covis_edges.tolist(),
        "tree": snap.tree_edges.tolist(),
        "loop": snap.loop_edges.tolist(),
        "traj": rnd(traj, 4),
    }
    page = _PAGE.replace("__DATA__", json.dumps(data))
    if autorefresh_s:
        page = page.replace(
            "<head>",
            f'<head><meta http-equiv="refresh" content="{autorefresh_s:g}">',
            1,
        )
    # atomic replace: a live-mode browser refresh must never read a
    # half-written file
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(page)
    os.replace(tmp, path)


def auto_target(snap: MapSnapshot) -> np.ndarray:
    """Scene centroid, exposed for tests."""
    c = _centers(snap.kf_poses)
    stack = np.concatenate([snap.points, c]) if snap.points.size else c
    return stack.mean(axis=0)
